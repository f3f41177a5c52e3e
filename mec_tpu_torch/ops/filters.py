"""Host-side (numpy) builders for the constant DSP operators.

A verbatim copy of mec_tpu/ops/filters.py (importing mec_tpu imports
jax); tests/test_torch_frontend.py pins it to the original.

These reproduce the exact filterbank/window/DCT math that librosa 0.10
applies inside the reference audio frontend
(reference preprocessing/audio_preprocessing.py:22-37, librosa==0.10.0 per
reference requirements.txt:13). They are computed once at trace time and
baked into the XLA graph as constants — on TPU the mel projection and DCT
become plain MXU matmuls.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def hann_window(n_fft: int = 2048) -> np.ndarray:
    """Periodic (fftbins=True) Hann window, scipy.signal.get_window('hann', n)."""
    k = np.arange(n_fft)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / n_fft)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def fft_frequencies(sr: int = 22050, n_fft: int = 2048) -> np.ndarray:
    return np.linspace(0.0, sr / 2.0, 1 + n_fft // 2, endpoint=True)


def _hz_to_mel(freq, htk: bool = False):
    freq = np.asanyarray(freq, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = freq >= min_log_hz
    mels = np.where(log_t, min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep, mels)
    return mels


def _mel_to_hz(mels, htk: bool = False):
    mels = np.asanyarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = mels >= min_log_mel
    return np.where(log_t, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


@functools.lru_cache(maxsize=None)
def mel_filterbank(sr: int = 22050, n_fft: int = 2048, n_mels: int = 128,
                   fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, (n_mels, 1 + n_fft//2).

    Matches librosa.filters.mel(htk=False, norm='slaney'), which is what
    librosa.feature.mfcc uses by default.
    """
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = fft_frequencies(sr, n_fft)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=None)
def dct_matrix(n_out: int = 40, n_in: int = 128) -> np.ndarray:
    """Orthonormal DCT-II matrix (n_out, n_in).

    mfcc = dct_matrix @ mel_db, matching
    scipy.fftpack.dct(x, type=2, axis=-2, norm='ortho')[:n_out] as used by
    librosa.feature.mfcc.
    """
    n = np.arange(n_in)
    k = np.arange(n_out)[:, None]
    basis = 2.0 * np.cos(np.pi * k * (2 * n + 1) / (2.0 * n_in))
    scale = np.full((n_out, 1), np.sqrt(1.0 / (2.0 * n_in)))
    scale[0, 0] = np.sqrt(1.0 / (4.0 * n_in))
    return (basis * scale).astype(np.float32)


@functools.lru_cache(maxsize=None)
def chroma_base_bins(sr: int = 22050, n_fft: int = 2048,
                     n_chroma: int = 12) -> np.ndarray:
    """Chroma bin numbers for FFT bins 1..n_fft//2 at tuning=0.

    librosa.filters.chroma computes
      frqbins = n_chroma * hz_to_octs(fftfreqs[1:], tuning, bins_per_octave)
    and hz_to_octs folds tuning in as log2(f / (440*2**(tuning/12) / 16)),
    so frqbins(tuning) == chroma_base_bins() - tuning. The traced frontend
    applies the (data-dependent) tuning shift on device.
    """
    fftfreqs = fft_frequencies(sr, n_fft)[1:]
    return (n_chroma * np.log2(16.0 * fftfreqs / 440.0)).astype(np.float64)
