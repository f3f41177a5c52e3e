"""Host-side (numpy) 56-dim audio feature frontend.

A copy of mec_tpu/ops/host_features.py (importing mec_tpu imports jax):
the same algorithm and the same constant tables (the port's
ops/filters.py, itself pinned to the original) as the device frontend
(ops/audio_features.py), so that bf16 serving with
MEC_HOST_AUDIO_FEATURES on can ship each clip's 56 float32 features
(224 bytes) instead of its packed waveform. numpy's pocketfft computes
the rFFT of float32 frames in single precision; the features agree
with the device frontend within 2e-2 on MFCCs (dB units), 1e-3 on
chroma and 1e-3 relative on the spectral scalars
(tests/test_host_features.py), and are computed from the unquantized
waveform. fp32 parity mode never uses this module.

`features_56_np` is the meaning of the C++ featurizer
(native/audiofeat.cpp, native/featurizer.py::extract56) and its
fallback on a host without g++; tests/test_torch_host_features.py pins
it bit for bit to the original.
"""

from __future__ import annotations

import numpy as np

from mec_tpu_torch.config import Config
from mec_tpu_torch.ops import filters

SR = Config.SAMPLE_RATE           # 22050
N_FFT = Config.N_FFT              # 2048
HOP = Config.HOP_LENGTH           # 512
N_MELS = Config.N_MELS            # 128
N_MFCC = Config.N_MFCC            # 40
N_CHROMA = 12
N_BINS = 1 + N_FFT // 2           # 1025

_TINY32 = float(np.finfo(np.float32).tiny)


def _frames(y: np.ndarray, pad_mode: str) -> np.ndarray:
    """Center-framed strided view, (B, T, N_FFT). pad_mode: 'constant'|'edge'."""
    pad = N_FFT // 2
    y_p = np.pad(y, ((0, 0), (pad, pad)), mode=pad_mode)
    n_frames = 1 + y.shape[1] // HOP
    return np.lib.stride_tricks.sliding_window_view(
        y_p, N_FFT, axis=1)[:, ::HOP][:, :n_frames]


def _spectrograms(y: np.ndarray):
    """One rFFT pass -> (magnitude, power), each (B, T, N_BINS) float32."""
    frames = _frames(y, 'constant') * filters.hann_window(N_FFT)
    z = np.fft.rfft(frames.astype(np.float32), axis=-1)
    mag = np.abs(z).astype(np.float32)
    return mag, mag * mag


def _power_to_db(S: np.ndarray, top_db: float = 80.0, amin: float = 1e-10
                 ) -> np.ndarray:
    log_spec = 10.0 * np.log10(np.maximum(amin, S))
    per_clip_max = log_spec.max(axis=tuple(range(1, S.ndim)), keepdims=True)
    return np.maximum(log_spec, per_clip_max - top_db)


def _mfcc_mean(P: np.ndarray) -> np.ndarray:
    mel_fb = filters.mel_filterbank(SR, N_FFT, N_MELS)           # (M, F)
    melspec = P @ mel_fb.T                                       # (B, T, M)
    mel_db = _power_to_db(melspec).astype(np.float32)
    mfcc = mel_db @ filters.dct_matrix(N_MFCC, N_MELS).T         # (B, T, C)
    return mfcc.mean(axis=1)


# ----------------------------------------------------------------------
# tuning estimation (librosa.estimate_tuning via piptrack) + chroma
# ----------------------------------------------------------------------

def _piptrack_candidates(S: np.ndarray, fmin: float = 150.0,
                         fmax: float = 4000.0, threshold: float = 0.1):
    """(B, T, F) power spectrogram -> (pitches, mags, mask), matching
    mec_tpu.ops.audio_features.piptrack_candidates."""
    avg_core = 0.5 * (S[..., 2:] - S[..., :-2])
    denom = 2.0 * S[..., 1:-1] - S[..., 2:] - S[..., :-2]
    shift_core = avg_core / (denom + (np.abs(denom) < _TINY32))
    zeros = np.zeros_like(S[..., :1])
    shift = np.concatenate([zeros, shift_core, zeros], axis=-1)
    dskew = 0.5 * np.concatenate([zeros, avg_core, zeros], axis=-1) * shift

    freqs = filters.fft_frequencies(SR, N_FFT).astype(np.float32)
    freq_mask = (freqs >= max(fmin, 0.0)) & (freqs < min(fmax, SR / 2.0))

    ref_value = threshold * S.max(axis=-1, keepdims=True)        # per frame
    masked = S * (S > ref_value)
    left = np.concatenate([masked[..., :1], masked[..., :-1]], axis=-1)
    right = np.concatenate([masked[..., 1:], masked[..., -1:]], axis=-1)
    localmax = (masked > left) & (masked >= right)

    mask = localmax & freq_mask
    bin_idx = np.arange(N_BINS, dtype=np.float32)
    pitches = np.where(mask, (bin_idx + shift) * np.float32(SR) / N_FFT, 0.0)
    mags = np.where(mask, S + dskew, 0.0)
    return (pitches.astype(np.float32), mags.astype(np.float32), mask)


def _estimate_tuning(P: np.ndarray, resolution: float = 0.01,
                     bins_per_octave: int = 12) -> np.ndarray:
    """Per-clip tuning deviation in fractional chroma bins, (B,)."""
    B = P.shape[0]
    pitches, mags, _ = _piptrack_candidates(P)
    freqs = filters.fft_frequencies(SR, N_FFT)
    band = (freqs >= 150.0) & (freqs < 4000.0)
    pitches = pitches[..., band].reshape(B, -1)
    mags = mags[..., band].reshape(B, -1)

    edges64 = np.linspace(-0.5, 0.5, int(np.ceil(1.0 / resolution)) + 1)
    out = np.zeros(B, np.float32)
    for b in range(B):
        pm = pitches[b] > 0
        if not pm.any():
            continue
        med = np.median(mags[b][pm])
        sel = (mags[b] >= med) & pm
        if not sel.any():
            continue
        octs = np.log2(pitches[b][sel].astype(np.float32) / np.float32(27.5))
        residual = np.mod(bins_per_octave * octs, np.float32(1.0))
        residual = np.where(residual >= 0.5, residual - 1.0, residual)
        counts, _ = np.histogram(residual, bins=edges64)
        out[b] = np.float32(edges64[np.argmax(counts)])
    return out


def _chroma_filterbank(tuning: np.ndarray, n_chroma: int = N_CHROMA,
                       ctroct: float = 5.0, octwidth: float = 2.0
                       ) -> np.ndarray:
    """(B,) tuning -> (B, n_chroma, N_BINS) per-clip chroma filterbank,
    matching mec_tpu.ops.audio_features.chroma_filterbank."""
    base = filters.chroma_base_bins(SR, N_FFT, n_chroma).astype(np.float32)
    frqbins = base[None, :] - tuning[:, None].astype(np.float32)
    first = frqbins[:, :1] - 1.5 * n_chroma
    frqbins = np.concatenate([first, frqbins], axis=-1)          # (B, F)

    widths = np.concatenate(
        [np.maximum(frqbins[:, 1:] - frqbins[:, :-1], 1.0),
         np.ones_like(frqbins[:, :1])], axis=-1)

    c = np.arange(n_chroma, dtype=np.float32)
    D = frqbins[:, None, :] - c[None, :, None]                   # (B, C, F)
    n2 = round(n_chroma / 2)
    D = np.remainder(D + n2 + 10 * n_chroma, n_chroma) - n2
    wts = np.exp(-0.5 * (2.0 * D / widths[:, None, :]) ** 2)

    norm = np.sqrt(np.sum(wts * wts, axis=1, keepdims=True))
    wts = wts / np.where(norm < _TINY32, 1.0, norm)
    wts = wts * np.exp(
        -0.5 * (((frqbins[:, None, :] / n_chroma) - ctroct) / octwidth) ** 2)
    return np.roll(wts, -3 * (n_chroma // 12), axis=1).astype(np.float32)


def _chroma_mean(P: np.ndarray) -> np.ndarray:
    fb = _chroma_filterbank(_estimate_tuning(P))                 # (B, C, F)
    raw = np.einsum('bcf,btf->btc', fb, P)
    length = np.max(np.abs(raw), axis=-1, keepdims=True)
    chroma = raw / np.where(length < _TINY32, 1.0, length)
    return chroma.mean(axis=1)


# ----------------------------------------------------------------------
# spectral scalars
# ----------------------------------------------------------------------

def _centroid_mean(mag: np.ndarray) -> np.ndarray:
    freqs = filters.fft_frequencies(SR, N_FFT).astype(np.float32)
    total = mag.sum(axis=-1, keepdims=True)
    norm = mag / np.where(total < _TINY32, 1.0, total)
    return (freqs * norm).sum(axis=-1).mean(axis=-1)


def _rolloff_mean(mag: np.ndarray, roll_percent: float = 0.85) -> np.ndarray:
    freqs = filters.fft_frequencies(SR, N_FFT).astype(np.float32)
    cum = np.cumsum(mag, axis=-1)
    hit = cum >= roll_percent * cum[..., -1:]
    big = np.float32(np.finfo(np.float32).max)
    return np.min(np.where(hit, freqs, big), axis=-1).mean(axis=-1)


def _zcr_mean(y: np.ndarray, threshold: float = 1e-10) -> np.ndarray:
    frames = _frames(y, 'edge')
    z = np.where(np.abs(frames) <= threshold, 0.0, frames)
    neg = np.signbit(z)
    crossings = neg[..., 1:] != neg[..., :-1]
    rate = crossings.sum(axis=-1).astype(np.float32) / N_FFT
    return rate.mean(axis=-1)


def _rms_mean(y: np.ndarray) -> np.ndarray:
    frames = _frames(y, 'constant')
    return np.sqrt((frames * frames).mean(axis=-1)).mean(axis=-1)


# ----------------------------------------------------------------------
# full 56-dim frontend
# ----------------------------------------------------------------------

def features_56_np(y: np.ndarray) -> np.ndarray:
    """(N,) or (B, N) float32 waveforms -> (B, 56) features.

    Same feature order as the device frontend / the reference
    (reference preprocessing/audio_preprocessing.py:40-46):
    40 MFCC, 12 chroma, [zcr, centroid, rolloff, rms].
    """
    y = np.asarray(y, np.float32)
    if y.ndim == 1:
        y = y[None, :]
    mag, P = _spectrograms(y)
    mfcc = _mfcc_mean(P)
    chroma = _chroma_mean(P)
    spectral = np.stack([_zcr_mean(y), _centroid_mean(mag),
                         _rolloff_mean(mag), _rms_mean(y)], axis=-1)
    return np.concatenate([mfcc, chroma, spectral],
                          axis=-1).astype(np.float32)
