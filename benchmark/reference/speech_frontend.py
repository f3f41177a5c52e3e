"""The 56 speech features in float32, librosa 0.10 semantics, written
plainly:

    concat(mfcc mean [40], chroma mean [12],
           [zcr, spectral centroid, spectral rolloff, rms] means)

Framing: n_fft 2048, hop 512, center=True (zero padding for the spectra
and rms, edge padding for zcr), periodic Hann. The power spectrogram
(|rfft|^2) feeds the mel filterbank (Slaney, 128 mels) -> power_to_db
(ref 1, amin 1e-10, top_db 80 over the clip) -> orthonormal DCT-II (40);
piptrack (150-4000 Hz, threshold 0.1) -> estimate_tuning (median
magnitude, histogram at resolution 0.01, numpy) -> the chroma filterbank
shifted by the tuning (base C, octave-weighted, L2 columns) -> per-frame
max normalisation. The centroid and the rolloff (85% of the cumulative
magnitude) come from the magnitude spectrogram.

The constant tables are written out here (the same formulas as librosa's
filters); nothing is imported from the program.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

SR, N_FFT, HOP, N_MELS, N_MFCC, N_CHROMA = 22050, 2048, 512, 128, 40, 12
N_BINS = 1 + N_FFT // 2
TINY = float(np.finfo(np.float32).tiny)


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                    / (np.log(6.4) / 27.0), lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)),
                    m * (200.0 / 3))


@functools.lru_cache(maxsize=None)
def tables():
    freqs = np.linspace(0.0, SR / 2.0, N_BINS)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SR / 2.0),
                                   N_MELS + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - freqs[None, :]
    weights = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None],
                                         ramps[2:] / fdiff[1:, None]))
    weights *= (2.0 / (mel_f[2:] - mel_f[:-2]))[:, None]
    n = np.arange(N_MELS)
    k = np.arange(N_MFCC)[:, None]
    dct = 2.0 * np.cos(np.pi * k * (2 * n + 1) / (2.0 * N_MELS))
    dct *= np.sqrt(1.0 / (2.0 * N_MELS))
    dct[0] *= np.sqrt(0.5)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(N_FFT) / N_FFT)
    chroma_base = N_CHROMA * np.log2(16.0 * freqs[1:] / 440.0)
    return {'freqs': freqs, 'mel': weights, 'dct': dct, 'hann': hann,
            'chroma_base': chroma_base}


def _t(name, device):
    return torch.as_tensor(tables()[name], dtype=torch.float32, device=device)


def frames(y: torch.Tensor, mode: str) -> torch.Tensor:
    """(B, N) -> (B, 1 + N // HOP, N_FFT), centred."""
    pad = N_FFT // 2
    if mode == 'edge':
        yp = torch.cat([y[:, :1].expand(-1, pad), y,
                        y[:, -1:].expand(-1, pad)], 1)
    else:
        yp = torch.nn.functional.pad(y, (pad, pad))
    return yp.unfold(1, N_FFT, HOP)


def estimate_tuning(S: np.ndarray) -> float:
    """librosa.estimate_tuning(S=power, sr, n_fft, bins_per_octave=12,
    resolution=0.01) on one clip's (T, F) power spectrogram (float64)."""
    freqs = tables()['freqs']
    avg = 0.5 * (S[:, 2:] - S[:, :-2])
    shift = 2 * S[:, 1:-1] - S[:, 2:] - S[:, :-2]
    shift = avg / (shift + (np.abs(shift) < TINY))
    avg = np.pad(avg, ((0, 0), (1, 1)))
    shift = np.pad(shift, ((0, 0), (1, 1)))
    dskew = 0.5 * avg * shift
    fmask = (freqs >= 150.0) & (freqs < 4000.0)
    ref = 0.1 * S.max(axis=1, keepdims=True)
    m = S * (S > ref)
    left = np.concatenate([m[:, :1], m[:, :-1]], 1)
    right = np.concatenate([m[:, 1:], m[:, -1:]], 1)
    idx = (m > left) & (m >= right) & fmask[None, :]
    pitch = ((np.arange(S.shape[1])[None, :] + shift) * SR / N_FFT)[idx]
    mag = (S + dskew)[idx]
    keep = pitch > 0
    pitch, mag = pitch[keep], mag[keep]
    if pitch.size == 0:
        return 0.0
    sel = pitch[mag >= np.median(mag)]
    residual = np.mod(12 * np.log2(sel / 27.5), 1.0)
    residual[residual >= 0.5] -= 1.0
    bins = np.linspace(-0.5, 0.5, 101)
    counts, edges = np.histogram(residual, bins)
    return float(edges[np.argmax(counts)])


def chroma_filterbank(tuning: torch.Tensor) -> torch.Tensor:
    """(B,) tuning -> (B, 12, F) librosa.filters.chroma(base_c=True)."""
    dev = tuning.device
    frq = _t('chroma_base', dev)[None, :] - tuning[:, None]
    frq = torch.cat([frq[:, :1] - 1.5 * N_CHROMA, frq], 1)
    widths = torch.cat([torch.clamp_min(frq[:, 1:] - frq[:, :-1], 1.0),
                        torch.ones_like(frq[:, :1])], 1)
    c = torch.arange(N_CHROMA, dtype=torch.float32, device=dev)
    D = frq[:, None, :] - c[None, :, None]
    D = torch.remainder(D + N_CHROMA // 2 + 10 * N_CHROMA, N_CHROMA) \
        - N_CHROMA // 2
    w = torch.exp(-0.5 * (2.0 * D / widths[:, None, :]) ** 2)
    norm = torch.sqrt((w * w).sum(1, keepdim=True))
    w = w / torch.where(norm < TINY, 1.0, norm)
    w = w * torch.exp(-0.5 * ((frq[:, None, :] / N_CHROMA - 5.0) / 2.0) ** 2)
    return torch.roll(w, -3, dims=1)


def features(y: torch.Tensor, prec, stage: str = 'speech_frontend'
             ) -> torch.Tensor:
    """(B, 66150) float32 waveforms -> (B, 56) features."""
    dev = y.device
    fr = frames(y, 'zero')
    win = prec.values(fr * _t('hann', dev), stage)
    mag = torch.fft.rfft(win, dim=-1).abs()
    mag = prec.values(mag, stage)
    P = mag * mag
    mel = prec.linear(P, _t('mel', dev).T, None, stage)
    db = 10.0 * torch.log10(torch.clamp_min(mel, 1e-10))
    db = torch.maximum(db, db.amax(dim=(1, 2), keepdim=True) - 80.0)
    mfcc = prec.linear(db, _t('dct', dev).T, None, stage).mean(1)
    tuning = torch.tensor([estimate_tuning(p) for p in
                           P.double().cpu().numpy()],
                          dtype=torch.float32, device=dev)
    chroma = prec.linear(P, chroma_filterbank(tuning).transpose(1, 2), None,
                         stage)
    length = chroma.abs().amax(-1, keepdim=True)
    chroma = (chroma / torch.where(length < TINY, 1.0, length)).mean(1)
    neg = frames(y, 'edge') < -1e-10
    zcr = (neg[..., 1:] != neg[..., :-1]).sum(-1).float().div(N_FFT).mean(1)
    freqs = _t('freqs', dev)
    total = mag.sum(-1, keepdim=True)
    centroid = (freqs * mag / torch.where(total < TINY, 1.0, total)
                ).sum(-1).mean(1)
    cum = torch.cumsum(mag, -1)
    hit = cum >= 0.85 * cum[..., -1:]
    rolloff = torch.where(hit, freqs, float('inf')).amin(-1).mean(1)
    rms = torch.sqrt((fr * fr).mean(-1)).mean(1)
    return torch.cat([mfcc, chroma,
                      torch.stack([zcr, centroid, rolloff, rms], -1)], -1)
