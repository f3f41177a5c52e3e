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
from mec_tpu_torch.ops._build import SM_COUNT
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


def test_kernel_tables_are_the_rounded_padded_transposed_bases():
    """The layouts the CUDA kernel reads (dft_kernel.kernel_tables) hold
    exactly the values of the plain version's tables: 'bf16' K-major
    bf16 rows, as .to(torch.bfloat16) rounds the fp32 tables, zero
    padding past bin 1024; 'highest' the 1024 tiled bins in 16-byte
    aligned fp32 rows and the Nyquist bin's two columns beside them."""
    cpu = torch.device('cpu')
    cos32, sin32 = dft_kernel._bases(cpu, 'highest')
    cosT, sinT, nyq = dft_kernel.kernel_tables(cpu, 'bf16')
    assert nyq.numel() == 0
    for table, ref, rounded in ((cosT, cos32, dft_kernel._bases(cpu, 'bf16')[0]),
                                (sinT, sin32, dft_kernel._bases(cpu, 'bf16')[1])):
        assert table.dtype == torch.bfloat16 and table.is_contiguous()
        assert table.shape == (dft_kernel.N_PAD, dft_kernel.N_FFT)
        assert dft_kernel.N_PAD % 8 == 0 and table.data_ptr() % 16 == 0
        assert torch.equal(table[:dft_kernel.N_BINS],
                           ref.t().to(torch.bfloat16))
        # the plain version's 'bf16' tables are these values in fp32
        assert torch.equal(table[:dft_kernel.N_BINS].float(), rounded.t())
        assert not table[dft_kernel.N_BINS:].any()
    cos, sin, nyq = dft_kernel.kernel_tables(cpu, 'highest')
    for table, ref, col in ((cos, cos32, nyq[0]), (sin, sin32, nyq[1])):
        assert table.dtype == torch.float32 and table.is_contiguous()
        assert table.shape == (dft_kernel.N_FFT, dft_kernel.N_TILED)
        assert table.data_ptr() % 16 == 0 and dft_kernel.N_TILED % 4 == 0
        assert torch.equal(table, ref[:, :dft_kernel.N_TILED])
        assert torch.equal(col, ref[:, dft_kernel.N_TILED])
    # the Nyquist bin: cos = (-1)^n exactly, sin the table's rounding noise
    n = torch.arange(dft_kernel.N_FFT)
    assert torch.equal(nyq[0], 1.0 - 2.0 * (n % 2))
    assert nyq[1].abs().max().item() < 1e-12


@pytest.mark.parametrize('m', [1, 130, 131, 4160])
def test_tile_grid_covers_every_output_once(m):
    """The tile and grid the wrapper hands the kernel, as the kernel cuts
    them (tiles over the 1024 bins below the Nyquist bin, that bin dealt
    out row by row to the blocks of a row tile): every (row, bin) of the
    (m, 1025) output is written exactly once, and one clip (130 rows)
    still launches a block for every SM."""
    bm, bn, gx, gy = dft_kernel.tile_grid(m)
    assert (bm, bn) in dft_kernel.TILES and gx * bn == dft_kernel.N_TILED
    hits = np.zeros((m, dft_kernel.N_BINS), np.int32)
    for by in range(gy):
        for bx in range(gx):
            hits[by * bm:min((by + 1) * bm, m), bx * bn:(bx + 1) * bn] += 1
            rows = dft_kernel.nyquist_rows(m, bm, gx, bx, by)
            hits[rows.start:rows.stop, dft_kernel.N_TILED] += 1
    assert hits.min() == hits.max() == 1
    if m >= 130:
        assert gx * gy >= SM_COUNT
    if m == 4160:
        assert (bm, bn, gx, gy) == (128, 64, 16, 33)    # four full waves


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
    fp32 engine takes the parity graph whatever the name says; a bad
    value raises at load of a bf16 engine only. (The waveform wire: the
    host audio features, which 'auto' turns on with >= 4 CPUs and g++,
    are pinned off.)"""
    from mec_tpu_torch.ops.speech_kernels import make_speech_dnn
    from mec_tpu_torch.serving.engine import EmotionEngine
    from mec_tpu_torch.serving.synthetic_artifacts import speech_variables
    tree = speech_variables(seed=1)
    waves = _waves()[:2]
    monkeypatch.setattr(Config, 'HOST_AUDIO_FEATURES', '0')
    monkeypatch.setattr(Config, 'DFT_PRECISION', 'highest')
    bf16 = EmotionEngine(tree, None, compute_dtype='bfloat16', device='cpu')
    fp32 = EmotionEngine(tree, None, compute_dtype='float32', device='cpu')
    monkeypatch.setattr(Config, 'DFT_PRECISION', 'high')
    assert (bf16._dft_precision, fp32._dft_precision) == ('highest', 'parity')
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
