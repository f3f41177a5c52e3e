"""K5 (dft_spectrograms) and the framed speech frontend against the JAX package.

Same numpy-seeded waveforms through both packages on the CPU. The JAX
side runs pallas_kernels.dft_spectrograms in Pallas interpret mode and,
for the frontend, audio_features_56(use_pallas=True) with
Config.DFT_PRECISION set to the precision under test (its framed
branch: K5, mfcc_mean_pallas, framed zcr/rms); the port runs the plain
versions of its kernels. Tolerances, each with its reason:

* K5 'highest': both sides sum fp32 products in different orders;
  mag atol 5e-5 and P relative 5e-3 (over P + 1e-6), the JAX package's
  own contract for K5 against the rFFT (tests/test_pallas.py:31-40),
  on that test's 0.1-scale noise clips;
* K5 'bf16': both sides round the operands to bf16 and sum exact fp32
  products, so they differ again only in summation order: the same
  bounds hold (the bf16 error floor is common to both);
* the framed frontend: MFCC atol 1e-4 and the other 16 columns rtol
  1e-4 for 'highest' (the JAX package's serving-against-reference
  bounds, tests/test_pallas.py:56-63) and, measured, the same for
  'bf16'. The port's rolloff is the crossing search (K3) where JAX on
  the CPU takes the cumsum: equal but for near-ties (ROADMAP C4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mec_tpu.config import Config as JaxConfig
from mec_tpu.ops import audio_features as jaf
from mec_tpu.ops import filters as jfilters
from mec_tpu.ops import pallas_kernels as pk
from mec_tpu_torch.config import Config
from mec_tpu_torch.ops import audio_features as taf
from mec_tpu_torch.ops import dft_kernel
from mec_tpu_torch.serving.wire import decode_pcm12

N = 66150


def _waves():
    """Noise, a two-tone chord over a noise floor, and a pure chirp (a
    spectrally sparse clip, where a bf16 DFT's error floor shows)."""
    rng = np.random.RandomState(3)
    t = np.arange(N) / 22050.0
    return np.stack([
        0.1 * rng.randn(N),
        0.3 * np.sin(2 * np.pi * 261.6 * t) + 0.2 * np.sin(2 * np.pi * 392.0 * t)
        + 0.01 * rng.randn(N),
        0.2 * np.sin(2 * np.pi * (300 + 700 * t) * t),
    ]).astype(np.float32)


@pytest.fixture(scope='module')
def frames():
    """(2, 130, 2048) Hann-windowed frames of the JAX kernel test's
    clips (0.1-scale noise: the absolute bound on mag is relative to a
    frame's L1 norm, which sets the rounding of its DFT sums), made by
    the JAX package."""
    y = jnp.asarray((np.random.RandomState(0).randn(2, N) * 0.1)
                    .astype(np.float32))
    win = jnp.asarray(jfilters.hann_window(jaf.N_FFT))
    return np.asarray(jaf.frame_signal(y, 'constant') * win)


def test_frame_signal_zcr_rms_match_jax():
    y = _waves()
    for edge, mode in ((False, 'constant'), (True, 'edge')):
        np.testing.assert_array_equal(
            taf.frame_signal(torch.from_numpy(y), edge).numpy(),
            np.asarray(jaf.frame_signal(jnp.asarray(y), mode)))
    np.testing.assert_allclose(taf.zcr_mean(torch.from_numpy(y)).numpy(),
                               np.asarray(jaf.zcr_mean(jnp.asarray(y))),
                               rtol=1e-6)
    np.testing.assert_allclose(taf.rms_mean(torch.from_numpy(y)).numpy(),
                               np.asarray(jaf.rms_mean(jnp.asarray(y))),
                               rtol=1e-5)


@pytest.mark.parametrize('precision', ['highest', 'bf16'])
def test_dft_plain_matches_pallas_interpret(frames, precision):
    ref_mag, ref_P = (np.asarray(a) for a in
                      pk.dft_spectrograms(jnp.asarray(frames), precision))
    mag, P = dft_kernel.dft_spectrograms(torch.from_numpy(frames.copy()),
                                         precision)
    assert mag.shape == P.shape == (2, 130, 1025)
    assert mag.dtype == P.dtype == torch.float32
    np.testing.assert_allclose(mag.numpy(), ref_mag, atol=5e-5)
    rel = np.abs(P.numpy() - ref_P) / (ref_P + 1e-6)
    assert rel.max() < 5e-3


def test_dft_bf16_rounds_operands():
    """'bf16' is a function of the bf16-rounded frames only, and differs
    from 'highest' by the bf16 floor."""
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 3, 2048)
                         .astype(np.float32))
    xr = x.to(torch.bfloat16).to(torch.float32)
    a = dft_kernel.dft_spectrograms(x, 'bf16')[1]
    b = dft_kernel.dft_spectrograms(xr, 'bf16')[1]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    c = dft_kernel.dft_spectrograms(x, 'highest')[1]
    assert 0 < (a - c).abs().max().item() < 1e-2 * c.abs().max().item()


def test_dft_wrapper_rejects_bad_input():
    with pytest.raises(ValueError, match='precision'):
        dft_kernel.dft_spectrograms(torch.zeros(1, 1, 2048), 'high')
    with pytest.raises(ValueError, match='expected'):
        dft_kernel.dft_spectrograms(torch.zeros(1, 2047), 'highest')
    with pytest.raises(ValueError, match='unsupported device'):
        dft_kernel.dft_spectrograms(torch.zeros(1, 1, 2048, device='meta'))


@pytest.mark.parametrize('precision', ['highest', 'bf16'])
def test_framed_frontend_matches_jax(monkeypatch, precision):
    y = _waves()
    monkeypatch.setattr(JaxConfig, 'DFT_PRECISION', precision)
    ref = np.asarray(jaf.audio_features_56(jnp.asarray(y), use_pallas=True))
    before = dft_kernel.dft_spectrograms.launches
    got = taf.audio_features_56(torch.from_numpy(y), precision).numpy()
    monkeypatch.setattr(Config, 'DFT_PRECISION', precision)
    np.testing.assert_array_equal(
        taf.audio_features_56(torch.from_numpy(y)).numpy(), got)
    assert dft_kernel.dft_spectrograms.launches == before  # CPU: plain
    assert got.shape == (3, 56)
    np.testing.assert_allclose(got[:, :40], ref[:, :40], atol=1e-4)
    np.testing.assert_allclose(got[:, 40:], ref[:, 40:], rtol=1e-4)


def test_frontend_precision_dispatch(monkeypatch):
    y = torch.from_numpy(_waves()[:1])
    hop = taf.audio_features_56(y, 'high')
    monkeypatch.setattr(Config, 'DFT_PRECISION', 'high')
    np.testing.assert_array_equal(taf.audio_features_56(y).numpy(),
                                  hop.numpy())
    framed = taf.audio_features_56(y, 'highest')
    # two algorithms for one function: the MFCCs agree to 1e-3
    np.testing.assert_allclose(framed[:, :40].numpy(), hop[:, :40].numpy(),
                               atol=1e-3)
    monkeypatch.setattr(Config, 'DFT_PRECISION', 'fp16')
    with pytest.raises(ValueError, match='fp16'):
        taf.audio_features_56(y)


def test_engine_fixes_dft_precision_at_load(monkeypatch):
    """A bf16 engine takes Config.DFT_PRECISION when it is built (as the
    JAX engine at trace time) and its speech step runs that frontend; an
    fp32 engine keeps the hop-slab frontend; a bad value raises at load."""
    from mec_tpu_torch.ops.speech_kernels import make_speech_dnn
    from mec_tpu_torch.serving.engine import EmotionEngine
    from mec_tpu_torch.serving.synthetic_artifacts import speech_variables
    tree = speech_variables(seed=1)
    waves = _waves()[:2]
    monkeypatch.setattr(Config, 'DFT_PRECISION', 'highest')
    bf16 = EmotionEngine(tree, None, compute_dtype='bfloat16', device='cpu')
    fp32 = EmotionEngine(tree, None, compute_dtype='float32', device='cpu')
    monkeypatch.setattr(Config, 'DFT_PRECISION', 'high')
    assert (bf16._dft_precision, fp32._dft_precision) == ('highest', 'high')
    wire = bf16._to_device(bf16._wire_waves(waves, 2))
    assert len(wire) == 2                          # the pcm12 wire
    got = bf16._speech_forward(wire)
    y = decode_pcm12(*wire)
    want = make_speech_dnn(tree, 'cpu')(taf.audio_features_56(y, 'highest'))
    torch.testing.assert_close(got, want[:, :71], rtol=0, atol=0)
    monkeypatch.setattr(Config, 'DFT_PRECISION', 'fp16')
    with pytest.raises(ValueError, match='fp16'):
        EmotionEngine(tree, None, compute_dtype='bfloat16', device='cpu')
    EmotionEngine(tree, None, compute_dtype='float32', device='cpu')
