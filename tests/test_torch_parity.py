"""The port's fp32 parity speech graph against the JAX package's.

In fp32 the JAX engine turns its Pallas path off, so its speech graph is
audio_features_56(use_pallas=False) (rFFT STFT, the MFCC by two matmuls,
framed zcr and rms, the rolloff from the chunked cumulative sum) and the
Flax SpeechDNN with live BatchNorm. The port's fp32 mode is the same
graph: audio_features_56(y, 'parity') and models.SpeechDNN. Both run on
the CPU here, on the same numpy-seeded inputs.

Tolerances, each with its reason:
  * spectrograms: 1e-6 of the clip's peak magnitude (XLA's FFT and
    pocketfft round differently, about 1e-7 of the peak);
  * features: |got - ref| <= 1e-4 + 2e-6 |ref| on all 56. The relative
    part only matters where a feature is large: MFCC0 of a pure tone or
    a near-silent clip (-480 .. -1131, where one f32 ulp is 6e-5 ..
    1.2e-4 and the two packages' DCT products add 128 same-signed dB
    values in other orders: torch's reaches 1.8e-3 from XLA's on the
    silent clip) and the two columns in Hz (centroid, rolloff: thousands,
    one f32 ulp at 5,000 Hz is 4.9e-4). On the standardized scale the
    DNN sees, all are below 1e-4;
  * masks, counts and the tuning estimate: exact;
  * engine: probabilities, log-probabilities (the logits up to their
    common shift) and the 64-dim penultimate within 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mec_tpu.convert import store
from mec_tpu.ops import audio_features as jaf
from mec_tpu.serving.engine import EmotionEngine as JaxEngine
from mec_tpu_torch.config import Config
from mec_tpu_torch.models.speech_dnn import SpeechDNN
from mec_tpu_torch.ops import audio_features as taf
from mec_tpu_torch.ops import (dft_kernel, rolloff_kernel, speech_kernels,
                               tuning_kernel)
from mec_tpu_torch.serving.engine import EmotionEngine
from mec_tpu_torch.serving.synthetic_artifacts import speech_variables
from tests.make_goldens import adversarial_signals, golden_signals

N = 66150
FEATURE_ATOL, FEATURE_RTOL = 1e-4, 2e-6


def _signals():
    """The adversarial waveforms behind tests/goldens/semantics_vectors.npz,
    the cases of tests/test_audio_frontend.py (tone, noise, quiet) and a
    chirp."""
    return {**adversarial_signals(), **golden_signals()}


SIGNALS = _signals()


@pytest.fixture(scope='module')
def batch():
    return np.stack(list(SIGNALS.values())).astype(np.float32)


@pytest.fixture(scope='module')
def jax_stft(batch):
    mag, P = jaf.stft_spectrograms(jnp.asarray(batch))
    return np.asarray(mag), np.asarray(P)


@pytest.fixture(scope='module')
def features(batch):
    """(port, JAX) parity features of every signal, (8, 56) each."""
    ref = np.asarray(jaf.audio_features_56(jnp.asarray(batch),
                                           use_pallas=False))
    before = {w: w.launches for w in (
        speech_kernels.mfcc_mean, tuning_kernel.tuning_select,
        rolloff_kernel.rolloff_bins, dft_kernel.dft_spectrograms)}
    got = taf.audio_features_56(torch.from_numpy(batch), 'parity').numpy()
    assert all(w.launches == n for w, n in before.items())   # CPU: plain
    return got, ref


# ----------------------------------------------------------------------
# the stages
# ----------------------------------------------------------------------

def test_stft_spectrograms_match_jax(batch, jax_stft):
    mag, P = taf.stft_spectrograms(torch.from_numpy(batch))
    rmag, rP = jax_stft
    assert mag.shape == P.shape == (len(SIGNALS), 130, 1025)
    assert mag.dtype == P.dtype == torch.float32
    peak = rmag.max(axis=(1, 2), keepdims=True)
    assert (np.abs(mag.numpy() - rmag) <= 1e-6 * peak).all()
    # the power is the square of the rounded magnitude, as in the reference
    assert torch.equal(P, mag * mag)
    np.testing.assert_array_equal(rP, rmag * rmag)


def test_power_to_db_matches_jax():
    S = np.abs(np.random.RandomState(3).randn(2, 5, 16)).astype(np.float32)
    S[0] *= 1e-9                      # under amin in places
    S[1, 2] = 0.0
    S[1, 0, 0] = 1e6                  # the clip max, 80 dB over most of it
    got = taf.power_to_db(torch.from_numpy(S)).numpy()
    ref = np.asarray(jaf.power_to_db(jnp.asarray(S)))
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert got[1].min() == pytest.approx(got[1].max() - 80.0)
    assert got[0].max() - got[0].min() < 80.0


def test_mfcc_mean_from_power_matches_jax(jax_stft):
    """Same power spectrogram into both MFCC stages."""
    _mag, P = jax_stft
    got = taf.mfcc_mean_from_power(torch.from_numpy(P.copy())).numpy()
    ref = np.asarray(jaf.mfcc_mean_from_power(jnp.asarray(P)))
    assert got.shape == (len(SIGNALS), 40)
    np.testing.assert_allclose(got, ref, atol=FEATURE_ATOL, rtol=FEATURE_RTOL)
    # and it is the function that K1 fuses: its plain version, bit for bit
    plain = speech_kernels.mfcc_mean_plain(torch.from_numpy(P.copy()))
    np.testing.assert_array_equal(got, plain.numpy())


@pytest.mark.parametrize('shape,chunk', [((3, 7, 1025), 256), ((4, 1025), 64),
                                         ((2, 512), 256), ((5, 100), 256)])
def test_cumsum_chunked_matches_jax(shape, chunk):
    """Same grouping as the reference: the pad to a multiple of the chunk,
    prefixes within chunks, then chunk prefixes. A few f32 ulps of slack:
    the two packages' matrix products add a chunk's 256 terms in other
    orders."""
    x = np.abs(np.random.RandomState(shape[-1]).randn(*shape)
               ).astype(np.float32)
    got = taf._cumsum_chunked(torch.from_numpy(x), chunk).numpy()
    ref = np.asarray(jaf._cumsum_chunked(jnp.asarray(x), chunk))
    assert got.shape == x.shape
    np.testing.assert_allclose(got, ref, rtol=2e-6)
    np.testing.assert_allclose(got, np.cumsum(x.astype(np.float64), -1),
                               rtol=1e-5)


def test_spectral_rolloff_mean_cumsum_matches_jax(jax_stft):
    mag, _P = jax_stft
    got = taf.spectral_rolloff_mean(torch.from_numpy(mag.copy())).numpy()
    ref = np.asarray(jaf.spectral_rolloff_mean(jnp.asarray(mag)))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    # rows with no energy: every prefix reaches the threshold 0 at bin 0
    zero = torch.zeros(1, 3, 1025)
    assert taf.spectral_rolloff_mean(zero).item() == 0.0
    assert taf.spectral_rolloff_mean(zero, use_kernel=True).item() == 0.0


def _tied_rows(n, seed=0):
    """Magnitude rows built so that, in exact arithmetic, the prefix at
    the crossing bin EQUALS 0.85 of the row total: the last bin is raised
    until total = prefix[k] / 0.85. Which side of the threshold the f32
    prefix falls on is then a matter of summation order alone."""
    x = np.abs(np.random.RandomState(seed).randn(n, 1025)).astype(np.float32)
    c = np.cumsum(x.astype(np.float64), axis=-1)
    k = np.argmax(c >= 0.85 * c[:, -1:], axis=-1)
    rows = np.arange(n)
    x[:, -1] = (x[:, -1] + c[rows, k] / 0.85 - c[:, -1]).astype(np.float32)
    return x, k


def test_parity_rolloff_follows_the_cumsum_not_the_crossing_search():
    """On exact ties the reference's chunked cumsum and a running sum
    (the crossing search's order, K3's plain version) disagree by one bin
    on about half the rows. The port's parity rolloff must fall with the
    reference: it takes the same grouping, so only the order inside the
    two matrix products is left to differ."""
    x, k = _tied_rows(600)
    freqs = np.asarray(jaf.filters.fft_frequencies(22050, 2048), np.float32)
    ref = np.asarray(jaf.spectral_rolloff_mean(jnp.asarray(x[:, None, :])))
    got = taf.spectral_rolloff_mean(torch.from_numpy(x[:, None, :])).numpy()
    search = freqs[rolloff_kernel.rolloff_bins_plain(
        torch.from_numpy(x)).numpy()]
    step = freqs[1]
    # every answer is the tie's bin or its neighbour
    for hz in (ref, got, search):
        assert (np.abs(hz - freqs[k]) <= step).all()
    agree_parity = float(np.mean(got == ref))
    agree_search = float(np.mean(search == ref))
    assert agree_search < 0.7, agree_search       # the ties do discriminate
    assert agree_parity > 0.8, agree_parity
    assert agree_parity > agree_search + 0.15


def test_piptrack_candidates_match_jax(jax_stft):
    _mag, P = jax_stft
    P = P[:3]
    pitches, mags, mask = taf.piptrack_candidates(torch.from_numpy(P.copy()))
    rp, rm, rmask = (np.asarray(a) for a in
                     jaf.piptrack_candidates(jnp.asarray(P)))
    assert mask.dtype == torch.bool and mask.shape == P.shape
    np.testing.assert_array_equal(mask.numpy(), rmask)
    np.testing.assert_allclose(pitches.numpy(), rp, rtol=1e-6)
    np.testing.assert_allclose(mags.numpy(), rm, rtol=1e-5)
    assert mask.any() and not (pitches.numpy()[~rmask] != 0).any()


def test_tuning_candidates_are_the_band_of_piptrack(jax_stft):
    """The band-limited, 2:1 compacted candidates the serving path feeds
    K2 are the full-width piptrack's candidates, value for value."""
    _mag, P = jax_stft
    P = torch.from_numpy(P[:3].copy())
    pitches, mags, mask = taf.piptrack_candidates(P)
    c_mags, c_pitches = taf.tuning_candidates(P)
    assert c_mags.shape == c_pitches.shape == (3, 130 * 179)
    for b in range(3):
        keep = c_pitches[b] > 0
        assert int(keep.sum()) == int(mask[b].sum())
        np.testing.assert_array_equal(np.sort(c_pitches[b][keep].numpy()),
                                      np.sort(pitches[b][mask[b]].numpy()))
        np.testing.assert_array_equal(np.sort(c_mags[b][keep].numpy()),
                                      np.sort(mags[b][mask[b]].numpy()))


# ----------------------------------------------------------------------
# the 56 features
# ----------------------------------------------------------------------

@pytest.mark.parametrize('i,name', list(enumerate(SIGNALS)))
def test_audio_features_56_parity_matches_jax(features, i, name):
    got, ref = features
    assert got.shape == ref.shape == (len(SIGNALS), 56)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got[i], ref[i], atol=FEATURE_ATOL,
                               rtol=FEATURE_RTOL, err_msg=name)
    # the integer-valued and exact parts: crossings and the tuning-shifted
    # chroma (a different tuning bin moves chroma by 1e-2)
    assert got[i, 52] == ref[i, 52]
    np.testing.assert_allclose(got[i, 40:52], ref[i, 40:52], atol=1e-6)


def test_audio_features_56_parity_on_standardized_scale(features):
    """Standardized by the spread of these clips (what a scaler fitted on
    them would do), every feature is within 1e-4."""
    got, ref = features
    scale = ref.std(axis=0) + 1e-3
    assert (np.abs(got - ref) / scale).max() <= 1e-4


def test_parity_branch_is_not_the_serving_branch(batch):
    """Two algorithms for one function: the hop-slab serving branch is
    within the serving tolerances of the parity branch, not equal to it;
    a 1-D clip is a batch of one."""
    y = torch.from_numpy(batch[4:6])              # tone, noise
    parity = taf.audio_features_56(y, 'parity')
    hop = taf.audio_features_56(y, 'high')
    assert not torch.equal(parity, hop)
    np.testing.assert_allclose(hop[:, :40].numpy(), parity[:, :40].numpy(),
                               atol=1e-2)
    np.testing.assert_allclose(hop[:, 40:].numpy(), parity[:, 40:].numpy(),
                               rtol=1e-3, atol=1e-3)
    one = taf.audio_features_56(y[0], 'parity')
    assert one.shape == (1, 56) and torch.equal(one[0], parity[0])


@pytest.mark.parametrize('i,name', list(enumerate(SIGNALS)))
def test_spectral_features_4_matches_jax_with_rolloff(batch, i, name):
    """[zcr, centroid, rolloff, rms] of the heuristic fallback, the rolloff
    column from the cumsum as in the reference."""
    y = batch[i:i + 1]
    got = taf.spectral_features_4(torch.from_numpy(y)).numpy()[0]
    ref = np.asarray(jaf.spectral_features_4(jnp.asarray(y)))[0]
    assert got[0] == ref[0]
    np.testing.assert_allclose(got[1:3], ref[1:3], rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(got[3], ref[3], atol=1e-7)
    mag, _P = taf.stft_spectrograms(torch.from_numpy(y))
    assert got[2] == taf.spectral_rolloff_mean(mag).item()


# ----------------------------------------------------------------------
# the engine in fp32
# ----------------------------------------------------------------------

def _strong_bn_tree(seed=5):
    """A full-width speech tree whose BatchNorm statistics are far from
    the identity: running means of order 1/2, variances over a decade,
    scales of either sign. Folding them into the Dense layers (what the
    bf16 kernel does) and normalising live are then different roundings
    of cancelling terms."""
    tree = speech_variables(seed=seed)
    rng = np.random.RandomState(seed + 100)
    for name, stats in tree['batch_stats'].items():
        w = stats['mean'].shape[0]
        stats['mean'] = (0.5 * rng.randn(w)).astype(np.float32)
        stats['var'] = (10.0 ** rng.uniform(-0.7, 0.3, w)).astype(np.float32)
        tree['params'][name]['scale'] = (
            rng.choice([-1.0, 1.0], w) * rng.uniform(0.5, 1.5, w)
        ).astype(np.float32)
        tree['params'][name]['bias'] = (0.2 * rng.randn(w)).astype(np.float32)
    return tree


@pytest.fixture(scope='module')
def engines(tmp_path_factory, batch):
    tree = _strong_bn_tree()
    feats = taf.audio_features_56(torch.from_numpy(batch), 'parity').numpy()
    mean = feats.mean(axis=0).astype(np.float32)
    scale = (feats.std(axis=0) + 1e-3).astype(np.float32)
    models = tmp_path_factory.mktemp('models')
    store.save_params(str(models / 'speech_model.mecp'), tree)
    np.savez(str(models / 'speech_scaler.npz'), mean=mean, scale=scale)
    jax_engine = JaxEngine(models_dir=str(models), mesh=None)
    assert jax_engine.speech is not None
    port = EmotionEngine(tree, (mean, scale), compute_dtype='float32',
                         device='cpu')
    return {'tree': tree, 'scaler': (mean, scale), 'jax': jax_engine,
            'port': port}


def test_fp32_engine_is_the_parity_graph(engines, batch):
    """The fp32 engine's speech step is audio_features_56(.., 'parity')
    and the plain SpeechDNN with live BatchNorm, bit for bit; it ships
    float32 samples."""
    port = engines['port']
    assert port._dft_precision == 'parity'
    model = port.speech['dnn'].model
    assert isinstance(model, SpeechDNN) and not model.training
    assert all(isinstance(bn, torch.nn.BatchNorm1d) for bn in model.bn)
    wire = port._to_device(port._wire_waves(batch[:3], 8))
    assert len(wire) == 1 and wire[0].dtype == torch.float32
    got = port._speech_forward(wire)
    mean, scale = (torch.from_numpy(a) for a in engines['scaler'])
    with torch.no_grad():
        probs, penult = model(
            (taf.audio_features_56(wire[0], 'parity') - mean) / scale)
    assert got.shape == (8, 71)
    assert torch.equal(got, torch.cat([probs, penult], dim=-1))


def test_fp32_engine_matches_jax_engine_with_strong_batchnorm(engines, batch):
    ref = engines['jax'].predict_speech_waves(batch, want_features=True)
    got = engines['port'].predict_speech_waves(batch, want_features=True)
    assert len(got) == len(ref) == len(SIGNALS)
    for g, r in zip(got, ref):
        gp, rp = (np.asarray(d['all_probabilities']) for d in (g, r))
        assert '_fallback' not in g and abs(gp.sum() - 1.0) < 1e-5
        np.testing.assert_allclose(gp, rp, atol=1e-4)
        assert rp.min() > 1e-7                    # no class is saturated away
        np.testing.assert_allclose(np.log(gp), np.log(rp), atol=1e-4)
        np.testing.assert_allclose(g['_features'], r['_features'], atol=1e-4)
        top2 = np.sort(rp)[-2:]
        if top2[1] - top2[0] > 1e-3:
            assert g['emotion'] == r['emotion']
    assert len({g['emotion'] for g in got}) > 1


def test_bf16_engine_keeps_the_serving_graph(engines, batch, monkeypatch):
    """bf16 mode is untouched: the pcm12 wire, the hop-slab frontend with
    the kernels' plain versions, the BN-folded fused forward. With this
    tree the folded forward and the live-BN module differ visibly less
    than the serving tolerances but more than rounding: the two modes are
    two graphs. (The waveform wire: the host audio features, which 'auto'
    turns on with >= 4 CPUs and g++, are pinned off.)"""
    monkeypatch.setattr(Config, 'HOST_AUDIO_FEATURES', '0')
    tree, scaler = engines['tree'], engines['scaler']
    bf16 = EmotionEngine(tree, scaler, compute_dtype='bfloat16', device='cpu')
    assert bf16._dft_precision == 'high'
    wire = bf16._to_device(bf16._wire_waves(batch[:3], 8))
    assert len(wire) == 2
    from mec_tpu_torch.serving.wire import decode_pcm12
    mean, scale = (torch.from_numpy(a) for a in scaler)
    x = (taf.audio_features_56(decode_pcm12(*wire), 'high') - mean) / scale
    want = speech_kernels.make_speech_dnn(tree, 'cpu')(x)[:, :71]
    assert torch.equal(bf16._speech_forward(wire), want)
    live = engines['port'].speech['dnn'](x)
    assert not torch.equal(live, want)
    np.testing.assert_allclose(live.numpy(), want.numpy(), atol=1e-3)
