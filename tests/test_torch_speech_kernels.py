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
