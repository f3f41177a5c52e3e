"""Port kernels K1-K4 (mec_tpu_torch) against the JAX Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
the Pallas function itself in interpret mode (called directly: the
on_tpu() gates in audio_features would route around it). Inputs are made
with numpy from a seed and handed to both packages. Tolerances are those
of the JAX package's own kernel tests: K1 atol 1e-4
(tests/test_pallas.py:47), K2 and K3 bit-exact (test_pallas_tuning.py,
test_pallas_rolloff.py), K4 probs 2e-6 / penult 2e-5
(test_pallas.py:91-105).

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mec_tpu.ops import audio_features as jaf
from mec_tpu.ops import pallas_kernels as pk
from mec_tpu.ops.pallas_rolloff import rolloff_bins_pallas
from mec_tpu.ops.pallas_tuning import tuning_select_pallas
from mec_tpu_torch.convert.from_jax import speech_state_from_jax
from mec_tpu_torch.models.speech_dnn import SpeechDNN
from mec_tpu_torch.ops import audio_features as taf
from mec_tpu_torch.ops import rolloff_kernel, speech_kernels, tuning_kernel
from mec_tpu_torch.serving.synthetic_artifacts import speech_variables

N = 66150


def _waves(B, seed=0):
    """Tones, chirps and noise at several levels, plus silence at row 0."""
    rng = np.random.RandomState(seed)
    t = np.arange(N) / 22050.0
    rows = [np.zeros(N)]
    for i in range(1, B):
        kind = i % 3
        if kind == 0:
            y = 0.3 * np.sin(2 * np.pi * (150 + 37 * i) * t) \
                + 0.1 * np.sin(2 * np.pi * (310 + 71 * i) * t)
        elif kind == 1:
            y = 0.2 * np.sin(2 * np.pi * (200 + 900 * t * i) * t)
        else:
            y = 0.05 * i * rng.randn(N)
        rows.append(y + 0.02 * rng.randn(N))
    return np.stack(rows).astype(np.float32)


def _power(B, seed=0):
    mag, P = jaf.hop_spectrograms(jnp.asarray(_waves(B, seed)))
    return np.asarray(mag), np.asarray(P)


@pytest.fixture(scope='module')
def power8():
    return _power(8)


# ----------------------------------------------------------------------
# K1 mfcc_mean
# ----------------------------------------------------------------------

def test_mfcc_mean_matches_pallas():
    """A chirp and noise at atol 1e-4; the silent clip (row 0) sits at
    MFCC0 = -1131.4, where one f32 ulp is 1.2e-4, so it is held at
    rtol 1e-6 instead."""
    _mag, P = _power(3, seed=1)
    ref = np.asarray(pk.mfcc_mean_pallas(jnp.asarray(P)))
    got = speech_kernels.mfcc_mean(torch.from_numpy(P)).numpy()
    assert got.shape == (3, 40)
    np.testing.assert_allclose(got[1:], ref[1:], atol=1e-4)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-6, atol=1e-4)


def test_mfcc_mean_rejects_other_frame_counts():
    with pytest.raises(ValueError, match='130'):
        speech_kernels.mfcc_mean(torch.zeros(1, 129, 1025))


def test_mel_runs_cover_every_nonzero():
    """The kernel visits only each mel's [lo, hi) bin run: every nonzero
    filterbank weight must lie inside it."""
    mel, lo, hi, _dct = (t.numpy() for t in
                         speech_kernels._mel_tables(torch.device('cpu')))
    cols = np.arange(mel.shape[1])[None, :]
    inside = (cols >= lo[:, None]) & (cols < hi[:, None])
    assert not np.any((mel != 0) & ~inside)
    assert (hi - lo).sum() < mel.size / 30      # banded: the kernel's win


def test_mel_taps_reproduce_dense_filterbank():
    """The kernel's table of nonzero taps, scattered back, is the dense
    Slaney filterbank bit for bit; every bin lies in at most one segment
    (so in at most two mels), the two mels of a bin are neighbours, and
    what pads the table is zero. An empty filter would get no tap."""
    from mec_tpu_torch.ops import filters
    taps, runs = speech_kernels.mel_taps()
    mel = filters.mel_filterbank(22050, 2048, 128)
    assert taps.dtype == np.float32 and runs.dtype == np.int32
    assert taps.size % 4 == 0 and runs.shape == (3, 128)
    assert np.array_equal(speech_kernels.dense_from_taps(taps, runs), mel)
    first, end, off = runs
    covered = np.zeros(1025, int)
    used = np.zeros(taps.size // 2, bool)
    for s in range(128):
        covered[first[s]:end[s]] += 1
        at = off[s] + 32 * np.arange(end[s] - first[s])
        assert not used[at].any()                 # no two bins share a pair
        used[at] = True
    assert covered.max() == 1
    assert (np.count_nonzero(mel, axis=0) <= 2).all()
    assert not taps.reshape(-1, 2)[~used].any()   # the padding is zeros
    for m in np.nonzero(~mel.any(axis=1))[0]:     # empty filters: no taps
        assert not speech_kernels.dense_from_taps(taps, runs)[m].any()
    # a lane's four segments (l, l + 32, ...) lie in four different blocks
    assert (off % 32 == np.arange(128) % 32).all()


@pytest.mark.parametrize('B', [1, 2, 4, 5, 8, 13, 32, 33, 64])
def test_frame_split_covers_every_frame_once(B):
    """K1's geometry: `split` blocks a clip, block r the frames
    [r * 130 / split, (r + 1) * 130 / split), its 13 warps taking the
    frames w, w + 13, ... of the block."""
    split = speech_kernels.frame_split(B)
    assert 1 <= split <= 16 and 130 % split == 0
    per = 130 // split
    seen = np.zeros(130, int)
    for rank in range(split):
        for warp in range(13):
            for t in range(warp, per, 13):
                seen[rank * per + t] += 1
    assert (seen == 1).all()


# ----------------------------------------------------------------------
# K2 tuning_select
# ----------------------------------------------------------------------

def _candidates(P):
    mags, pitches = taf.tuning_candidates(torch.from_numpy(P))
    residual = taf.fold_residual(pitches)
    return mags.numpy(), residual.numpy(), pitches.numpy()


def _assert_tuning_equal(mags, residual, pitches):
    rb, rh = tuning_select_pallas(jnp.asarray(mags), jnp.asarray(residual),
                                  jnp.asarray(pitches))
    gb, gh = tuning_kernel.tuning_select(torch.from_numpy(mags),
                                         torch.from_numpy(residual),
                                         torch.from_numpy(pitches))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(rb))
    np.testing.assert_array_equal(gh.numpy(), np.asarray(rh))
    return gb.numpy(), gh.numpy()


def test_tuning_select_matches_pallas(power8):
    _mag, P = power8
    mags, residual, pitches = _candidates(P)
    assert mags.shape == (8, 130 * 179)
    _best, has = _assert_tuning_equal(mags, residual, pitches)
    assert not has[0] and has[1:].all()       # row 0 is silence


def test_tuning_select_silence_and_ties():
    """An all-zero row takes the no-candidate path; two bins with equal
    counts exercise the first-argmax rule; an even candidate count with
    duplicated magnitudes exercises the upper middle of the median;
    residuals exactly on the edges exercise the bin boundaries."""
    K = 23270
    rng = np.random.RandomState(3)
    mags = np.zeros((4, K), np.float32)
    residual = np.zeros((4, K), np.float32)
    pitches = np.zeros((4, K), np.float32)
    # row 1: two bins with equal counts -> the lower one wins
    idx = rng.choice(K, 40, replace=False)
    pitches[1, idx] = 220.0
    mags[1, idx] = 1.0
    residual[1, idx[:20]] = 0.105
    residual[1, idx[20:]] = -0.205
    # row 2: 64 candidates (even count), distinct magnitudes with ties
    idx = rng.choice(K, 64, replace=False)
    pitches[2, idx] = 330.0
    mags[2, idx] = np.repeat(rng.rand(32), 2).astype(np.float32)
    residual[2, idx] = rng.uniform(-0.5, 0.5, 64).astype(np.float32)
    # row 3: residuals exactly on the edges (the ceil-to-f32 table)
    edges = tuning_kernel.hist_edges_ceil32()
    idx = rng.choice(K, 101, replace=False)
    pitches[3, idx] = 440.0
    mags[3, idx] = 2.0
    residual[3, idx] = edges[rng.randint(0, 100, 101)]
    best, has = _assert_tuning_equal(mags, residual, pitches)
    assert not has[0] and best[0] == 0
    assert best[1] == np.searchsorted(edges, -0.205, side='right') - 1


@pytest.mark.parametrize('B', [1, 2, 8, 16, 17, 32, 33, 34, 66, 67, 128])
def test_cluster_split_fills_the_card_and_no_more(B):
    """K2's geometry: the largest of 8, 4, 2 blocks a clip whose clusters
    all fit the card's SMs at once (a block holds a whole row's slots, so
    an SM runs one block); one block a clip beyond that."""
    from mec_tpu_torch.ops import _build
    split = tuning_kernel.cluster_split(B)
    assert split in (1, 2, 4, 8) and split <= tuning_kernel.MAX_SPLIT
    assert split == 1 or B * split <= _build.SM_COUNT
    assert split == 8 or B * split * 2 > _build.SM_COUNT
    assert tuning_kernel.cluster_split(32) == 4      # 128 of the 132 SMs
    assert tuning_kernel.cluster_split(1) == 8


@pytest.mark.parametrize('split', [1, 2, 4, 8])
@pytest.mark.parametrize('K', [23270, 4099, 7, 1])
def test_slot_slices_cover_every_slot_once(K, split):
    """Each block of a cluster streams one slice of the row: together
    every slot once, in order, the last ones shorter or empty."""
    slices = tuning_kernel.slot_slices(K, split)
    assert len(slices) == split
    seen = np.zeros(K, int)
    for lo, hi in slices:
        assert 0 <= lo <= hi <= K
        seen[lo:hi] += 1
    assert (seen == 1).all()
    sizes = [hi - lo for lo, hi in slices]
    assert sizes == sorted(sizes, reverse=True) and sizes[0] == -(-K // split)


def _kernel_constants(source):
    """constexpr ints of a kernel source, by name."""
    import re
    from mec_tpu_torch.ops import _build
    text = (_build.CSRC / source).read_text()
    return {m[1]: int(m[2]) for m in
            re.finditer(r'constexpr int (k\w+) = (\d+);', text)}, text


def test_tuning_shared_memory_budget():
    """MAX_K is what fits: all K slots' keys and residual bins (8 bytes a
    slot, every slot a candidate at worst) beside the kernel's own
    arrays, read from the source: the top-digit histogram, the short
    list, the bin histogram and its edges, per-warp scratch."""
    c, text = _kernel_constants('tuning_select.cu')
    assert c['kThreads'] == 1024 and c['kMaxSplit'] == tuning_kernel.MAX_SPLIT
    assert c['kBins'] == tuning_kernel.N_HIST_BINS
    assert c['kTopBits'] + 2 * c['kLowBits'] == 32   # the rounds cover a key
    warps = c['kThreads'] // 32
    own = 4 * ((1 << c['kTopBits']) + c['kShort'] + 2 * warps + 3
               + (c['kBins'] + 1) + c['kBins'] + 3)
    assert own <= tuning_kernel.STATIC_SMEM_BYTES
    assert '2 * K * (int)sizeof(uint32_t)' in text   # SLOT_BYTES a slot
    assert tuning_kernel.smem_bytes(tuning_kernel.MAX_K) \
        <= tuning_kernel.SMEM_LIMIT_BYTES
    assert tuning_kernel.smem_bytes(tuning_kernel.MAX_K + 1000) \
        > tuning_kernel.SMEM_LIMIT_BYTES             # and not far below it
    assert tuning_kernel.MAX_K >= 130 * 179          # the serving row fits
    big = torch.ones(1, tuning_kernel.MAX_K + 1)
    tuning_kernel.tuning_select(big, big, big)       # the CPU twin has no limit


def _radix_median_keys(mags, top_bits=12, low_bits=10, short=2048):
    """The kernel's route to the lower and upper middle of the candidate
    magnitudes, in numpy: order keys (-0 as +0), the top digit from a
    histogram, that bin on a short list (or every key when it outgrows
    the list), two rounds of low digits, then the next larger key from
    the list or, failing that, from all keys."""
    u = mags.astype(np.float32).view(np.uint32).astype(np.int64)
    u[u == 0x80000000] = 0
    keys = np.where(u & 0x80000000, 0xFFFFFFFF - u, u | 0x80000000)
    n = len(keys)
    lo_t, hi_t = (n - 1) // 2, n // 2
    shift = 32 - top_bits
    hist = np.bincount(keys >> shift, minlength=1 << top_bits)
    below = np.cumsum(hist) - hist
    d = int(np.nonzero((below <= lo_t) & (lo_t < below + hist))[0][0])
    listed = hist[d] <= short
    pool = keys[(keys >> shift) == d] if listed else keys
    prefix, fixed, target = d << shift, ((1 << top_bits) - 1) << shift, \
        lo_t - int(below[d])
    for sh in (low_bits, 0):
        match = pool[(pool & fixed) == prefix]
        h = np.bincount((match >> sh) & ((1 << low_bits) - 1),
                        minlength=1 << low_bits)
        b = np.cumsum(h) - h
        dd = int(np.nonzero((b <= target) & (target < b + h))[0][0])
        prefix |= dd << sh
        fixed |= ((1 << low_bits) - 1) << sh
        target -= int(b[dd])
    k_lo = prefix
    cnt_le = int((pool <= k_lo).sum()) + (int(below[d]) if listed else 0)
    k_hi = k_lo
    if cnt_le < hi_t + 1:
        above = pool[pool > k_lo]
        if not len(above):
            above = keys[keys > k_lo]
        k_hi = int(above.min())
    return k_lo, k_hi


@pytest.mark.parametrize('case', ['spread', 'octave', 'tied', 'pairs',
                                  'signed_zero', 'one', 'two', 'negative'])
def test_radix_digits_pin_the_bisection_medians(case):
    """The kernel's radix route (12 + 10 + 10 bits, short list, next key)
    gives the plain version's lower and upper middle on magnitudes that
    stress it: many exponents, one octave, four tied values (the bin
    outgrows the list), every value twice (the upper middle is the lower
    one), both zeros, one and two candidates, negative values."""
    rng = np.random.RandomState(7)
    mags = {
        'spread': np.exp(rng.uniform(-20, 5, 5001)),
        'octave': 1.0 + rng.rand(9000),
        'tied': np.floor(rng.rand(6000) * 4) + 1,
        'pairs': np.repeat(rng.rand(700), 2),
        'signed_zero': np.where(rng.rand(400) > 0.5, 0.0, -0.0),
        'one': np.array([3.25]),
        'two': np.array([2.0, 1.0]),
        'negative': rng.randn(4000),
    }[case].astype(np.float32)
    k_lo, k_hi = _radix_median_keys(mags)
    t = torch.from_numpy(mags)[None, :]
    n = mags.size
    want_lo = tuning_kernel._kth_smallest(t, torch.tensor([(n - 1) // 2]))
    want_hi = tuning_kernel._kth_smallest(t, torch.tensor([n // 2]))
    values = tuning_kernel._key_values(torch.tensor([k_lo, k_hi]))
    assert values[0].item() == want_lo.item()        # -0 == +0 here
    assert values[1].item() == want_hi.item()
    assert values[0].item() == np.sort(mags)[(n - 1) // 2]
    assert values[1].item() == np.sort(mags)[n // 2]


def test_residual_bin_guess_steps_to_the_table_bin():
    """The kernel bins a residual by arithmetic, then steps against the
    edge table; the guess must land within a step or two of the table's
    bin for every residual in range, edges and their neighbours
    included, or the steps would be a search."""
    edges = tuning_kernel.hist_edges_ceil32()
    r = np.concatenate([
        np.random.RandomState(0).uniform(-0.5, 0.5, 20000).astype(np.float32),
        edges[:-1], np.nextafter(edges[1:], np.float32(-1)),
        np.nextafter(edges[:-1], np.float32(1))])
    r = r[(r >= edges[0]) & (r < edges[-1])]
    table = np.searchsorted(edges, r, side='right') - 1
    guess = np.clip(((r + np.float32(0.5)) * np.float32(100)).astype(np.int32),
                    0, 99)
    assert np.abs(guess - table).max() <= 1


def test_hist_edges_copy_matches_original():
    np.testing.assert_array_equal(tuning_kernel.hist_edges_ceil32(),
                                  jaf._hist_edges_ceil32())


# ----------------------------------------------------------------------
# K3 rolloff_bins
# ----------------------------------------------------------------------

def test_rolloff_bins_matches_pallas(power8):
    """260 rows of real magnitude spectrogram (two clips) plus 70 random
    continuous rows and an all-zero row: bit-exact bins."""
    mag, _P = power8
    rng = np.random.RandomState(1)
    rows = np.concatenate([
        mag[2:4].reshape(-1, 1025),
        rng.rand(70, 1025).astype(np.float32) + 1e-3,
        np.zeros((1, 1025), np.float32)])
    ref = np.asarray(rolloff_bins_pallas(jnp.asarray(rows)))
    got = rolloff_kernel.rolloff_bins(torch.from_numpy(rows)).numpy()
    assert got.dtype == np.int32 and got.shape == (331,)
    np.testing.assert_array_equal(got, ref)
    assert got[-1] == 0


def test_rolloff_edge_rows():
    F = 1025
    rows = np.zeros((3, F), np.float32)
    rows[0, 0] = 5.0
    rows[1, F - 1] = 3.0
    rows[2, :] = 1.0
    got = rolloff_kernel.rolloff_bins(torch.from_numpy(rows)).numpy()
    ref = np.asarray(rolloff_bins_pallas(jnp.asarray(rows)))
    np.testing.assert_array_equal(got, ref)
    assert list(got[:2]) == [0, F - 1]


@pytest.mark.parametrize('R', [1, 130, 131, 1040, 1041, 4160, 4161, 4290])
def test_rows_per_block_leaves_a_block_for_every_sm(R):
    """K3's geometry: a warp a row, 1 to 8 rows a block; fewer than 8
    only while that keeps at least one block for each SM; the last block
    is ragged when R is not a multiple."""
    from mec_tpu_torch.ops import _build
    rows = rolloff_kernel.rows_per_block(R)
    assert 1 <= rows <= rolloff_kernel.MAX_ROWS_PER_BLOCK
    blocks = -(-R // rows)
    assert blocks * rows >= R > (blocks - 1) * rows
    assert rows == 1 or blocks >= _build.SM_COUNT
    assert rows == 8 or -(-R // (rows + 1)) < _build.SM_COUNT
    c, _text = _kernel_constants('rolloff_bins.cu')
    assert c['kMaxWarps'] == rolloff_kernel.MAX_ROWS_PER_BLOCK


@pytest.mark.parametrize('F', [1025, 1024, 1023, 2049, 33, 32, 7, 1])
def test_lane_bins_and_row_buffer(F):
    """Lane l of a row's warp owns ceil(F / 32) consecutive bins: together
    every bin once, in order. The row sits in its buffer shifted by the
    source's misalignment (0 to 3 floats), so the 16-byte copies of the
    aligned body are aligned on both sides and the buffer holds the row
    at every shift; 8 buffers of the serving width fit the 48 KB a launch
    gets unasked."""
    runs = rolloff_kernel.lane_bins(F)
    assert len(runs) == 32
    seen = np.zeros(F, int)
    at = 0
    for lo, hi in runs:
        assert lo == min(at, F) and hi - lo <= -(-F // 32)
        seen[lo:hi] += 1
        at = hi
    assert (seen == 1).all()
    size = rolloff_kernel.row_buffer_floats(F)
    assert size % 4 == 0
    for shift in range(4):
        head = min((4 - shift) % 4, F)
        assert shift + F <= size
        assert (shift + head) % 4 == 0 or head == F   # the body is aligned
    if F == 1025:
        assert 8 * size * 4 <= 48 * 1024
        # a stride of 33 words: the 32 lanes read 32 different banks
        assert len({lo % 32 for lo, _hi in runs}) == 32


def _lane_scan_bins(rows, roll_percent=0.85):
    """The kernel's order of sums in numpy f32: serial lane sums, a
    Hillis-Steele scan of the 32 of them, the first lane at or over the
    threshold walks its bins from its exclusive prefix."""
    R, F = rows.shape
    out = np.zeros(R, np.int32)
    for r in range(R):
        runs = rolloff_kernel.lane_bins(F)
        sums = np.zeros(32, np.float32)
        for l, (lo, hi) in enumerate(runs):
            acc = np.float32(0)
            for k in range(lo, hi):
                acc = np.float32(acc + rows[r, k])
            sums[l] = acc
        incl = sums.copy()
        off = 1
        while off < 32:
            up = np.concatenate([np.zeros(off, np.float32), incl[:-off]])
            incl = np.where(np.arange(32) >= off, incl + up, incl
                            ).astype(np.float32)
            off *= 2
        thresh = np.float32(np.float32(roll_percent) * incl[31])
        hit = np.nonzero(incl >= thresh)[0]
        if not len(hit):
            out[r] = F - 1
            continue
        lo, hi = runs[hit[0]]
        run = incl[hit[0] - 1] if hit[0] else np.float32(0)
        found = hi - 1
        for k in range(lo, hi):
            run = np.float32(run + rows[r, k])
            if run >= thresh:
                found = k
                break
        out[r] = found
    return out


@pytest.mark.parametrize('F', [1025, 257, 33])
def test_lane_scan_order_finds_the_crossing_bin(F):
    """The kernel's summation order (emulated in numpy f32) against the
    plain version: equal bins, or a one-bin step where the f64 prefix
    lies within the f32 sum's rounding of the threshold. Rows: random
    spectra, a single spike in every lane's first and last bin, and the
    all-zero row."""
    rng = np.random.RandomState(F)
    rows = [rng.rand(24, F) ** 4, np.zeros((1, F))]
    spikes = np.zeros((6, F))
    for i, k in enumerate((0, F - 1, F // 2, 32, min(33, F - 1), F // 3)):
        spikes[i, k] = 2.5
    rows = np.concatenate(rows + [spikes]).astype(np.float32)
    got = _lane_scan_bins(rows)
    want = rolloff_kernel.rolloff_bins_plain(torch.from_numpy(rows)).numpy()
    assert got[24] == 0
    np.testing.assert_array_equal(got[25:], want[25:])
    for r in np.nonzero(got != want)[0]:
        cum = np.cumsum(rows[r].astype(np.float64))
        lo = min(got[r], want[r])
        assert abs(int(got[r]) - int(want[r])) == 1
        assert abs(cum[lo] - 0.85 * cum[-1]) <= F * 2.0 ** -24 * cum[-1]


# ----------------------------------------------------------------------
# K4 speech_dnn
# ----------------------------------------------------------------------

@pytest.fixture(scope='module')
def tree():
    return speech_variables(seed=0)


def test_fold_batchnorm_matches_original(tree):
    ref = pk.fold_batchnorm(tree)
    got = speech_kernels.fold_batchnorm(tree)
    assert set(got) == set(ref) and got['n_blocks'] == 5
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]))


def test_speech_dnn_matches_pallas_full_width(tree):
    x = np.random.RandomState(5).randn(8, 56).astype(np.float32)
    ref = np.asarray(pk.make_speech_dnn_pallas(tree)(jnp.asarray(x)))
    fwd = speech_kernels.make_speech_dnn(tree, 'cpu')
    got = fwd(torch.from_numpy(x)).numpy()
    assert got.shape == (8, 128)
    assert (fwd.n_classes, fwd.penult_dim) == (7, 64)
    np.testing.assert_allclose(got[:, :7], ref[:, :7], atol=2e-6)
    np.testing.assert_allclose(got[:, 7:71], ref[:, 7:71], atol=2e-5)
    assert np.all(got[:, 71:] == 0)
    np.testing.assert_allclose(got[:, :7].sum(axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize('B', [1, 8, 9, 32, 33, 64])
def test_dnn_grid_covers_every_row_once(B):
    """K4's geometry: a cluster of DNN_CLUSTER blocks per tile of rows;
    in a tile the block of rank r writes the rows i with
    i % DNN_CLUSTER == r."""
    rows, tiles = speech_kernels.dnn_grid(B)
    assert rows == speech_kernels.DNN_ROWS and (tiles - 1) * rows < B <= tiles * rows
    seen = np.zeros(B, int)
    for tile in range(tiles):
        n = min(rows, B - tile * rows)
        for rank in range(speech_kernels.DNN_CLUSTER):
            for i in range(rank, n, speech_kernels.DNN_CLUSTER):
                seen[tile * rows + i] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize('which', ['full', 'narrow'])
def test_make_speech_dnn_caches_dims(tree, which):
    """The ctypes widths are built once, in make_speech_dnn, match the
    tree, and every call looks the same object up."""
    from mec_tpu_torch.bench.kernel_ab import NARROW, narrow_tree
    variables, want = ((tree, (56, 512, 512, 256, 128, 64, 7))
                       if which == 'full' else (narrow_tree(), NARROW))
    fwd = speech_kernels.make_speech_dnn(variables, 'cpu')
    assert fwd.dims == want and list(fwd.c_dims) == list(want)
    assert speech_kernels._c_dims(fwd.dims) is fwd.c_dims
    n = sum(a * b + b for a, b in zip(want, want[1:]))
    assert fwd.params.shape == (n,)
    out = fwd(torch.zeros(3, 56))
    assert out.shape == (3, 128) and bool((out[:, 7 + want[-2]:] == 0).all())


def test_speech_dnn_module_matches_flax_and_folded(tree):
    """The plain nn.Module (unfolded BN) against the Flax model, and the
    folded forward against the module."""
    from mec_tpu.models.speech_dnn import SpeechDNN as FlaxSpeechDNN
    x = np.random.RandomState(6).randn(6, 56).astype(np.float32)
    ref_p, ref_pen = FlaxSpeechDNN().apply(tree, jnp.asarray(x))
    model = SpeechDNN().eval()
    model.load_state_dict(speech_state_from_jax(tree))
    with torch.no_grad():
        probs, pen = model(torch.from_numpy(x))
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref_p), atol=2e-6)
    np.testing.assert_allclose(pen.numpy(), np.asarray(ref_pen), atol=2e-5)
    packed = speech_kernels.make_speech_dnn(tree, 'cpu')(torch.from_numpy(x))
    np.testing.assert_allclose(packed[:, :7].numpy(), probs.numpy(),
                               atol=2e-6)
    np.testing.assert_allclose(packed[:, 7:71].numpy(), pen.numpy(),
                               atol=2e-5)


# ----------------------------------------------------------------------
# wrappers: device dispatch and launch counters
# ----------------------------------------------------------------------

def _wrapper_calls(device):
    P = torch.zeros(1, 130, 1025, device=device)
    cand = torch.zeros(1, 64, device=device)
    fwd = speech_kernels.make_speech_dnn(speech_variables(seed=1), device)
    return {
        'mfcc_mean': lambda: speech_kernels.mfcc_mean(P),
        'tuning_select': lambda: tuning_kernel.tuning_select(cand, cand, cand),
        'rolloff_bins': lambda: rolloff_kernel.rolloff_bins(P[0]),
        'speech_dnn': lambda: fwd(torch.zeros(2, 56, device=device)),
    }


_WRAPPERS = {'mfcc_mean': speech_kernels.mfcc_mean,
             'tuning_select': tuning_kernel.tuning_select,
             'rolloff_bins': rolloff_kernel.rolloff_bins,
             'speech_dnn': speech_kernels.speech_dnn}


@pytest.mark.parametrize('name', sorted(_WRAPPERS))
def test_cpu_tensor_leaves_launch_count_at_zero(name):
    wrapper = _WRAPPERS[name]
    wrapper.launches = 0
    _wrapper_calls('cpu')[name]()
    assert wrapper.launches == 0


_META_CALLS = {
    'mfcc_mean': lambda: speech_kernels.mfcc_mean(
        torch.zeros(1, 130, 1025, device='meta')),
    'tuning_select': lambda: tuning_kernel.tuning_select(
        *(torch.zeros(1, 8, device='meta'),) * 3),
    'rolloff_bins': lambda: rolloff_kernel.rolloff_bins(
        torch.zeros(4, 1025, device='meta')),
    'speech_dnn': lambda: speech_kernels.speech_dnn(
        torch.zeros(2, 56, device='meta'), torch.zeros(1), (56, 7)),
}


@pytest.mark.parametrize('name', sorted(_WRAPPERS))
def test_wrapper_rejects_other_devices(name):
    """Neither CPU nor CUDA: the wrapper raises instead of guessing."""
    with pytest.raises(ValueError, match='unsupported device'):
        _META_CALLS[name]()
