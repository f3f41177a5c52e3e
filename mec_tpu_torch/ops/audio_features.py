"""The 56-dim speech frontend in torch: the serving branches and the
fp32 parity graph.

Port of mec_tpu/ops/audio_features.py::audio_features_56:

    features[b] = concat(mfcc_mean[40], chroma_mean[12],
                         [zcr, spectral_centroid, spectral_rolloff, rms])

Three spectrogram branches, chosen by `precision`. The two serving
branches (bf16 mode) are the hop-slab branch ('high', :723-734) and the
framed branch ('highest' or 'bf16', :735-743), whose windowed frames go
through the DFT kernel (K5); both take the MFCC kernel (K1) and the
rolloff crossing search (K3). The parity branch ('parity', :744-748, what
the reference runs with use_pallas=False in fp32 mode) is the rFFT STFT,
the mel and DCT products as two fp32 matmuls, the framed zcr and rms,
and the rolloff from the chunked cumulative sum. librosa 0.10 semantics
throughout (n_fft 2048, hop 512, periodic Hann, center=True with zero
padding; see the original's module docstring). Plain tensor work stays
in torch: the hop-DFT, mel, DCT, chroma and cumsum products are fp32
torch.matmul, as the JAX package leaves them to XLA. The per-clip
kernels go through their wrappers: dft_spectrograms (K5, framed
branch), mfcc_mean (K1), tuning_select (K2, every branch: the reference
takes its tuning kernel on the device whatever the branch),
rolloff_bins (K3); on a CPU tensor each runs its plain version.
MEC_PALLAS_TUNING=0 and MEC_PALLAS_ROLLOFF=0 (Config) turn K2 and K3 off
on the card as well, as they turn off the JAX package's kernels.

`spectral_features_4` is the speech heuristic's input: the rFFT STFT
and the cumsum rolloff; it is a fallback, not the serving path.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from mec_tpu_torch.config import Config
from mec_tpu_torch.ops import filters
from mec_tpu_torch.ops.dft_kernel import PRECISIONS, dft_spectrograms
from mec_tpu_torch.ops.rolloff_kernel import rolloff_bins
from mec_tpu_torch.ops.speech_kernels import mfcc_mean
from mec_tpu_torch.ops.tuning_kernel import (tuning_select,
                                              tuning_select_plain)

SR = Config.SAMPLE_RATE          # 22050
N_SAMPLES = Config.AUDIO_SAMPLES  # 66150
N_FFT = Config.N_FFT              # 2048
HOP = Config.HOP_LENGTH           # 512
N_MELS = Config.N_MELS            # 128
N_MFCC = Config.N_MFCC            # 40
N_CHROMA = 12
N_BINS = 1 + N_FFT // 2           # 1025
N_FRAMES = 1 + N_SAMPLES // HOP   # 130 (center=True framing)

_TINY32 = float(np.finfo(np.float32).tiny)
_BIG32 = float(np.finfo(np.float32).max)

_HOP_RATIO = N_FFT // HOP                       # 4
_HOP_TOTAL = (N_FRAMES - 1) * HOP + N_FFT      # samples covering all frames
_N_HOPS = _HOP_TOTAL // HOP                    # 133

# librosa.piptrack defaults as invoked by estimate_tuning
PIP_FMIN = 150.0
PIP_FMAX = 4000.0
PIP_THRESHOLD = 0.1


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device):
    """Device copies of the frontend's constant tables."""
    n = np.arange(HOP)[:, None]
    k = np.arange(N_BINS + 1)[None, :]
    ang = 2.0 * np.pi * n * k / N_FFT
    kk = np.arange(N_BINS + 1)
    m = (np.arange(4)[:, None] * kk[None, :]) % 4
    tables = {
        # unwindowed hop DFT bases at 2048-point resolution, (HOP, 1026)
        'cos': np.cos(ang).astype(np.float32),
        'sin': (-np.sin(ang)).astype(np.float32),
        # exact frame-assembly twiddles e^{-i pi i k / 2}, (4, 1026)
        'tw_re': np.array([1.0, 0.0, -1.0, 0.0], np.float32)[m],
        'tw_im': np.array([0.0, -1.0, 0.0, 1.0], np.float32)[m],
        'freqs': filters.fft_frequencies(SR, N_FFT).astype(np.float32),
        'chroma_base': filters.chroma_base_bins(SR, N_FFT,
                                                N_CHROMA).astype(np.float32),
        'nearest': np.linspace(-0.5, 0.5, 101).astype(np.float32),
        'hann': filters.hann_window(N_FFT),
        'mel': filters.mel_filterbank(SR, N_FFT, N_MELS),        # (M, F)
        'dct': filters.dct_matrix(N_MFCC, N_MELS),               # (C, M)
    }
    return {name: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for name, a in tables.items()}


def _hops(y: torch.Tensor, edge: bool) -> torch.Tensor:
    """Center-padded signal as (B, _N_HOPS, HOP); zero or edge padding."""
    pad = N_FFT // 2
    if edge:
        y_p = torch.cat([y[:, :1].expand(-1, pad), y,
                         y[:, -1:].expand(-1, pad)], dim=1)
    else:
        y_p = torch.nn.functional.pad(y, (pad, pad))
    return y_p[:, :_HOP_TOTAL].reshape(y.shape[0], _N_HOPS, HOP)


def hop_spectrograms(y: torch.Tensor):
    """(mag, power), each (B, 130, 1025), via one shared-basis hop DFT and
    the frequency-domain Hann stencil (audio_features.hop_spectrograms):
    every 512-sample hop uses the same unwindowed basis, frame t combines
    hop spectra t..t+3 with exact {1,-i,-1,i} twiddles, and the periodic
    Hann window is V[k] = 0.5 U[k] - 0.25 (U[k-1] + U[k+1])."""
    c = _consts(y.device)
    B = y.shape[0]
    flat = _hops(y, edge=False).reshape(B * _N_HOPS, HOP)
    hre = (flat @ c['cos']).reshape(B, _N_HOPS, N_BINS + 1)
    him = (flat @ c['sin']).reshape(B, _N_HOPS, N_BINS + 1)
    tre, tim = c['tw_re'], c['tw_im']
    ure = sum(hre[:, i:i + N_FRAMES] * tre[i] - him[:, i:i + N_FRAMES] * tim[i]
              for i in range(_HOP_RATIO))
    uim = sum(hre[:, i:i + N_FRAMES] * tim[i] + him[:, i:i + N_FRAMES] * tre[i]
              for i in range(_HOP_RATIO))
    # bin 1025 exists only as k=1024's right neighbour; k=0 uses
    # U[-1] = conj(U[1]) (real frames)
    vre = 0.5 * ure[..., 1:-1] - 0.25 * (ure[..., :-2] + ure[..., 2:])
    vim = 0.5 * uim[..., 1:-1] - 0.25 * (uim[..., :-2] + uim[..., 2:])
    vre0 = 0.5 * ure[..., :1] - 0.5 * ure[..., 1:2]
    vim0 = 0.5 * uim[..., :1]
    vre = torch.cat([vre0, vre], dim=-1)
    vim = torch.cat([vim0, vim], dim=-1)
    P = vre * vre + vim * vim
    return torch.sqrt(P), P


def frame_signal(y: torch.Tensor, edge: bool) -> torch.Tensor:
    """Center-framed signal (B, N_FRAMES, N_FFT), zero or edge padding.
    Gather-free: frame t is hops t..t+3 side by side."""
    hops = _hops(y, edge)
    return torch.cat([hops[:, i:i + N_FRAMES] for i in range(_HOP_RATIO)],
                     dim=-1)


def stft_spectrograms(y: torch.Tensor):
    """One rFFT pass -> (magnitude, power), each (B, 130, 1025): the parity
    graph's spectrogram. The power is the square of the rounded fp32
    magnitude, as in the reference, not re^2 + im^2."""
    frames = frame_signal(y, edge=False) * _consts(y.device)['hann']
    mag = torch.fft.rfft(frames, dim=-1).abs().to(torch.float32)
    return mag, mag * mag


def power_to_db(S: torch.Tensor, top_db: float = 80.0, amin: float = 1e-10
                ) -> torch.Tensor:
    """librosa.power_to_db with ref=1.0; the max is taken per clip (over
    every axis but the first)."""
    log_spec = 10.0 * torch.log10(torch.clamp_min(S, amin))
    per_clip_max = log_spec.amax(dim=tuple(range(1, S.dim())), keepdim=True)
    return torch.maximum(log_spec, per_clip_max - top_db)


def mfcc_mean_from_power(P: torch.Tensor) -> torch.Tensor:
    """(B, T, F) power spectrogram -> (B, 40) time-averaged MFCCs by two
    fp32 matmuls (mel, then DCT per frame): the parity graph's MFCC stage;
    the serving branches run the fused kernel mfcc_mean (K1)."""
    c = _consts(P.device)
    mel_db = power_to_db(P @ c['mel'].T)
    return (mel_db @ c['dct'].T).mean(dim=1)


def zcr_mean(y: torch.Tensor, threshold: float = 1e-10) -> torch.Tensor:
    """zero_crossing_rate mean over edge-padded frames (the first slot of
    each frame never counts, as zero_crossings' pad=True)."""
    neg = frame_signal(y, edge=True) < -threshold
    rate = (neg[..., 1:] != neg[..., :-1]).sum(dim=-1).to(torch.float32)
    return (rate / N_FFT).mean(dim=-1)


def rms_mean(y: torch.Tensor) -> torch.Tensor:
    """rms mean over zero-padded frames."""
    frames = frame_signal(y, edge=False)
    return torch.sqrt((frames * frames).mean(dim=-1)).mean(dim=-1)


def zcr_mean_hops(y: torch.Tensor, threshold: float = 1e-10) -> torch.Tensor:
    """zero_crossing_rate mean from per-hop crossing counts plus hop
    boundary pairs (edge padding): identical integer counts to framing."""
    neg = _hops(y, edge=True) < -threshold
    intra = (neg[..., 1:] != neg[..., :-1]).sum(dim=-1)      # (B, H)
    bound = neg[:, 1:, 0] != neg[:, :-1, -1]                 # (B, H-1)
    cr = sum(intra[:, i:i + N_FRAMES] for i in range(_HOP_RATIO))
    cr = cr + sum(bound[:, i:i + N_FRAMES].to(cr.dtype)
                  for i in range(_HOP_RATIO - 1))
    return (cr.to(torch.float32) / N_FFT).mean(dim=-1)


def rms_mean_hops(y: torch.Tensor) -> torch.Tensor:
    """rms mean from sliding sums of per-hop energies (zero padding)."""
    hc = _hops(y, edge=False)
    e = (hc * hc).sum(dim=-1)                                # (B, H)
    fe = sum(e[:, i:i + N_FRAMES] for i in range(_HOP_RATIO))
    return torch.sqrt(fe / N_FFT).mean(dim=-1)


def piptrack_candidates(P: torch.Tensor, fmin: float = PIP_FMIN,
                        fmax: float = PIP_FMAX,
                        threshold: float = PIP_THRESHOLD):
    """Parabolic-interpolated pitch candidates at full width
    (audio_features.piptrack_candidates, librosa.piptrack's defaults):
    (pitches, mags, mask), each (B, T, F); non-candidates have pitch =
    mag = 0. The reference implementation that the band-limited
    tuning_candidates is tested against."""
    S = P
    avg_core = 0.5 * (S[..., 2:] - S[..., :-2])
    denom = 2.0 * S[..., 1:-1] - S[..., 2:] - S[..., :-2]
    shift_core = avg_core / (denom + (denom.abs() < _TINY32).to(denom.dtype))
    avg = torch.nn.functional.pad(avg_core, (1, 1))
    shift = torch.nn.functional.pad(shift_core, (1, 1))
    dskew = 0.5 * avg * shift
    freqs = _consts(P.device)['freqs']
    freq_mask = (freqs >= max(fmin, 0.0)) & (freqs < min(fmax, SR / 2.0))
    ref_value = threshold * S.amax(dim=-1, keepdim=True)      # per frame
    masked = S * (S > ref_value).to(S.dtype)
    # localmax with edge padding: the first bin compares against itself
    # (False), the last bin's right neighbour is itself (>= holds)
    left = torch.cat([masked[..., :1], masked[..., :-1]], dim=-1)
    right = torch.cat([masked[..., 1:], masked[..., -1:]], dim=-1)
    mask = (masked > left) & (masked >= right) & freq_mask
    bin_idx = torch.arange(S.shape[-1], dtype=torch.float32, device=P.device)
    # librosa multiplies by sr before dividing by n_fft; keep that order
    pitches = torch.where(mask, (bin_idx + shift) * float(SR) / N_FFT, 0.0)
    mags = torch.where(mask, S + dskew, 0.0)
    return pitches, mags, mask


def tuning_candidates(P: torch.Tensor):
    """Piptrack candidates of the tuning estimator, band-limited and 2:1
    compacted (audio_features.estimate_tuning_from_power :370-421).

    Returns (mags, pitches), each (B, K) with K = 130 * 179: only the
    [PIP_FMIN, PIP_FMAX) band can hold candidates, and piptrack's localmax
    test (strict left, >= right) never keeps two adjacent bins, so each
    (2j, 2j+1) pair holds at most one and is compacted into one slot."""
    B = P.shape[0]
    freqs = filters.fft_frequencies(SR, N_FFT)
    band = np.nonzero((freqs >= PIP_FMIN) & (freqs < PIP_FMAX))[0]
    lo_bin, hi_bin = int(band[0]), int(band[-1]) + 1
    S = P[..., lo_bin - 1:hi_bin + 1]                        # band + margin
    avg = 0.5 * (S[..., 2:] - S[..., :-2])
    denom = 2.0 * S[..., 1:-1] - S[..., 2:] - S[..., :-2]
    shift = avg / (denom + (denom.abs() < _TINY32).to(denom.dtype))
    dskew = 0.5 * avg * shift
    ref_value = PIP_THRESHOLD * P.amax(dim=-1, keepdim=True)
    masked = S * (S > ref_value).to(S.dtype)
    localmax = ((masked[..., 1:-1] > masked[..., :-2])
                & (masked[..., 1:-1] >= masked[..., 2:]))
    bin_idx = torch.arange(lo_bin, hi_bin, dtype=torch.float32,
                           device=P.device)
    # librosa multiplies by sr before dividing by n_fft; keep that order
    pitches = torch.where(localmax, (bin_idx + shift) * float(SR) / N_FFT,
                          0.0)
    mags = torch.where(localmax, S[..., 1:-1] + dskew, 0.0)
    if pitches.shape[-1] % 2:
        pitches = torch.nn.functional.pad(pitches, (0, 1))
        mags = torch.nn.functional.pad(mags, (0, 1))
    p2 = pitches.reshape(pitches.shape[:-1] + (-1, 2))
    m2 = mags.reshape(mags.shape[:-1] + (-1, 2))
    left = p2[..., 0] > 0
    pitches = torch.where(left, p2[..., 0], p2[..., 1]).reshape(B, -1)
    mags = torch.where(left, m2[..., 0], m2[..., 1]).reshape(B, -1)
    return mags, pitches


def fold_residual(pitches: torch.Tensor, bins_per_octave: int = 12
                  ) -> torch.Tensor:
    """bins_per_octave * log2(f / 27.5) mod 1, folded to [-0.5, 0.5);
    non-candidates (pitch 0) get a value the selection never counts."""
    octs = torch.log2(torch.where(pitches > 0, pitches, 1.0) / 27.5)
    residual = torch.remainder(bins_per_octave * octs, 1.0)
    return torch.where(residual >= 0.5, residual - 1.0, residual)


def estimate_tuning_from_power(P: torch.Tensor) -> torch.Tensor:
    """Per-clip tuning deviation in fractional chroma bins, (B,)
    (librosa.estimate_tuning at resolution 0.01)."""
    mags, pitches = tuning_candidates(P)
    # MEC_PALLAS_TUNING=0 runs the plain selection on the card too
    # (audio_features.py:423-425 reads the same flag)
    select = tuning_select if Config.PALLAS_TUNING else tuning_select_plain
    best, has = select(mags, fold_residual(pitches), pitches)
    nearest = _consts(P.device)['nearest']
    return torch.where(has, nearest[best.long()], 0.0)


def chroma_filterbank(tuning: torch.Tensor, n_chroma: int = N_CHROMA,
                      ctroct: float = 5.0, octwidth: float = 2.0
                      ) -> torch.Tensor:
    """Per-clip chroma filterbank (B, n_chroma, N_BINS): librosa.filters.chroma
    with base_c=True and column-wise L2 norm, every bin centre shifted by
    -tuning fractional bins."""
    base = _consts(tuning.device)['chroma_base']                # (F-1,)
    frqbins = base[None, :] - tuning[:, None]                   # (B, F-1)
    first = frqbins[:, :1] - 1.5 * n_chroma                     # DC stand-in
    frqbins = torch.cat([first, frqbins], dim=-1)               # (B, F)
    widths = torch.cat(
        [torch.clamp_min(frqbins[:, 1:] - frqbins[:, :-1], 1.0),
         torch.ones_like(frqbins[:, :1])], dim=-1)              # (B, F)
    c = torch.arange(n_chroma, dtype=torch.float32, device=tuning.device)
    D = frqbins[:, None, :] - c[None, :, None]                  # (B, C, F)
    n2 = round(n_chroma / 2)
    D = torch.remainder(D + n2 + 10 * n_chroma, n_chroma) - n2
    wts = torch.exp(-0.5 * (2.0 * D / widths[:, None, :]) ** 2)
    norm = torch.sqrt((wts * wts).sum(dim=1, keepdim=True))
    wts = wts / torch.where(norm < _TINY32, 1.0, norm)
    wts = wts * torch.exp(
        -0.5 * (((frqbins[:, None, :] / n_chroma) - ctroct) / octwidth) ** 2)
    # rotate so bin 0 = C (base_c): roll by -3 chroma rows
    return torch.roll(wts, -3 * (n_chroma // 12), dims=1)


def chroma_mean_from_power(P: torch.Tensor) -> torch.Tensor:
    """(B, T, F) power spectrogram -> (B, 12) time-averaged chroma."""
    fb = chroma_filterbank(estimate_tuning_from_power(P))       # (B, C, F)
    raw = P @ fb.transpose(1, 2)                                # (B, T, C)
    length = raw.abs().amax(dim=-1, keepdim=True)
    chroma = raw / torch.where(length < _TINY32, 1.0, length)
    return chroma.mean(dim=1)


def spectral_centroid_mean(mag: torch.Tensor) -> torch.Tensor:
    freqs = _consts(mag.device)['freqs']
    total = mag.sum(dim=-1, keepdim=True)
    norm = mag / torch.where(total < _TINY32, 1.0, total)
    return (freqs * norm).sum(dim=-1).mean(dim=-1)


def _cumsum_chunked(x: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """Cumulative sum along the last axis with the reference's grouping
    (audio_features._cumsum_chunked): the axis zero-padded to a multiple
    of `chunk` (1025 -> 1280; the pad is part of the grouping), a
    triangular product for the prefixes within each chunk, a second
    small one for the exclusive prefixes of the chunk totals, and their
    sum. torch.cumsum would add the same terms in another grouping, so a
    near-tie at the rolloff threshold would fall differently more often."""
    F = x.shape[-1]
    pad = (-F) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    n_chunks = (F + pad) // chunk
    xr = x.reshape(x.shape[:-1] + (n_chunks, chunk))
    # U[i, j] = 1 iff i <= j: within[.., c, j] = sum_{i<=j} xr[.., c, i]
    ones = torch.ones(chunk, chunk, dtype=x.dtype, device=x.device)
    within = xr @ torch.triu(ones)                     # (.., n_chunks, chunk)
    totals = within[..., -1]                           # (.., n_chunks)
    prefix = totals @ torch.triu(ones[:n_chunks, :n_chunks], diagonal=1)
    return (within + prefix[..., None]).reshape(x.shape)[..., :F]


def spectral_rolloff_mean(mag: torch.Tensor, roll_percent: float = 0.85,
                          use_kernel: bool = False) -> torch.Tensor:
    """Mean rolloff frequency (the lowest bin reaching 85% of the frame's
    magnitude), (B,).

    Default (the parity graph, audio_features.py:629-636): the chunked
    cumulative sum, the lowest frequency whose prefix reaches the
    threshold. use_kernel=True (the bf16 serving branches, the
    reference's use_pallas): the crossing bins from K3. Exact bin -> Hz
    map there: (SR/2)/(F-1) = 11025 * 2**-10 and k * 11025 < 2**24 are
    both f32-representable, so k * step == fft_frequencies[k] bitwise.
    The two sum in different orders, so a bin can differ on a near-tie:
    the parity graph never takes the kernel, nor MEC_PALLAS_ROLLOFF=0
    (audio_features.py:618)."""
    if use_kernel and Config.PALLAS_ROLLOFF:
        B, T, F = mag.shape
        bins = rolloff_bins(mag.reshape(B * T, F), roll_percent).reshape(B, T)
        step = np.float32(SR / 2.0 / (F - 1))
        return (bins.to(torch.float32) * float(step)).mean(dim=-1)
    cum = _cumsum_chunked(mag)
    hit = cum >= roll_percent * cum[..., -1:]
    freqs = _consts(mag.device)['freqs']
    return torch.where(hit, freqs, _BIG32).amin(dim=-1).mean(dim=-1)


def audio_features_56(y: torch.Tensor, precision: Optional[str] = None
                      ) -> torch.Tensor:
    """(B, 66150) float32 waveforms -> (B, 56) features: 40 MFCC, 12 chroma,
    then [zcr, centroid, rolloff, rms].

    precision (None reads Config.DFT_PRECISION): 'high' takes the
    hop-slab frontend; 'highest' or 'bf16' the framed frontend, whose
    Hann-windowed frames go through K5 at that precision, with zcr and
    rms from the frames (audio_features.py:735-743); 'parity' the fp32
    reference graph (:744-748, the reference's use_pallas=False): rFFT
    STFT, the MFCC by two matmuls, framed zcr and rms, the cumsum
    rolloff. K1 and K3 are serving kernels and are not in the parity
    graph; the tuning selection (K2) is in every branch."""
    precision = Config.DFT_PRECISION if precision is None else precision
    if y.dim() == 1:
        y = y[None, :]
    if precision == 'high':
        mag, P = hop_spectrograms(y)
        zcr, rms = zcr_mean_hops(y), rms_mean_hops(y)
    elif precision in PRECISIONS:
        frames = frame_signal(y, edge=False) * _consts(y.device)['hann']
        mag, P = dft_spectrograms(frames, precision)
        zcr, rms = zcr_mean(y), rms_mean(y)
    elif precision == 'parity':
        mag, P = stft_spectrograms(y)
        zcr, rms = zcr_mean(y), rms_mean(y)
    else:
        raise ValueError(f'DFT precision {precision!r}: expected high, '
                         'highest, bf16 or parity')
    serving = precision != 'parity'
    mfcc = mfcc_mean(P) if serving else mfcc_mean_from_power(P)
    chroma = chroma_mean_from_power(P)
    spectral = torch.stack([zcr, spectral_centroid_mean(mag),
                            spectral_rolloff_mean(mag, use_kernel=serving),
                            rms], dim=-1)
    return torch.cat([mfcc, chroma, spectral], dim=-1)


def spectral_features_4(y: torch.Tensor) -> torch.Tensor:
    """[zcr, centroid, rolloff, rms], (B, 4), from the rFFT STFT and the
    cumsum rolloff: the heuristic fallback's input
    (audio_features.spectral_features_4)."""
    if y.dim() == 1:
        y = y[None, :]
    mag, _P = stft_spectrograms(y)
    return torch.stack([zcr_mean(y), spectral_centroid_mean(mag),
                        spectral_rolloff_mean(mag), rms_mean(y)], dim=-1)
