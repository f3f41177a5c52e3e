"""Speech-path kernels K1 (mfcc_mean) and K4 (the fused speech DNN).

The counterpart of mec_tpu/ops/pallas_kernels.py. Each wrapper checks
its input, runs the plain PyTorch version for a CPU tensor, and for a
CUDA tensor launches its hand-written kernel (csrc/mfcc_mean.cu,
csrc/speech_dnn.cu) or raises; it never falls back. `wrapper.launches`
counts the kernel launches, so a run can show that the serving path went
through the kernels.

Both kernels launch as thread block clusters (sm_90): K1 one cluster of
`frame_split(B)` blocks per clip, each block a run of whole frames; K4
one cluster of `DNN_CLUSTER` blocks per tile of `DNN_ROWS` rows
(`dnn_grid(B)`). The cluster sizes are chosen here and handed to the C
interface, and the CPU tests pin the geometry.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from mec_tpu_torch.config import Config
from mec_tpu_torch.ops import _build, filters

N_BINS = 1 + Config.N_FFT // 2                       # 1025
N_FRAMES = 1 + Config.AUDIO_SAMPLES // Config.HOP_LENGTH  # 130
N_MELS = Config.N_MELS                               # 128
N_MFCC = Config.N_MFCC                               # 40
PACKED_COLS = 128                                    # [probs | penult | 0]

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib_mfcc():
    lib = _build.library()
    lib.mec_mfcc_mean.argtypes = [_P, _I, _I, _I, _P, _I, _P, _P, _I, _P, _P]
    lib.mec_mfcc_mean.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _lib_dnn():
    lib = _build.library()
    lib.mec_speech_dnn.argtypes = [_P, _P, ctypes.POINTER(_I), _I, _I, _I,
                                   _P, _P]
    lib.mec_speech_dnn.restype = _I
    return lib


# ----------------------------------------------------------------------
# K1: fused mel -> dB -> DCT -> time mean
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _mel_tables(device: torch.device):
    """mel (M, F), its per-row nonzero bin runs [lo, hi), dct (C, M)."""
    mel = filters.mel_filterbank(Config.SAMPLE_RATE, Config.N_FFT, N_MELS)
    nz = mel != 0
    lo = np.argmax(nz, axis=1).astype(np.int32)
    hi = (N_BINS - np.argmax(nz[:, ::-1], axis=1)).astype(np.int32)
    hi[~nz.any(axis=1)] = lo[~nz.any(axis=1)]   # an empty filter: no run
    dct = filters.dct_matrix(N_MFCC, N_MELS)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (mel, lo, hi, dct))


def mel_taps() -> Tuple[np.ndarray, np.ndarray]:
    """The filterbank's nonzero taps for the kernel, by bin.

    A bin feeds at most two mels, and they are neighbours, so the bins
    fall into N_MELS contiguous segments: segment s holds the bins whose
    lowest mel is s. Returns `taps`, float32 pairs (mel[s, k],
    mel[s + 1, k]) (exact copies of the dense values; the second is 0
    for the last mel), and `runs` (3, M) int32 = each segment's first
    bin, end and offset, with bin first + i of segment s at pair
    offset[s] + 32 * i. A warp's lane l takes the segments l, l + 32,
    ...: each such group of 32 segments is one block of pairs, (longest
    segment of the group, 32), so that the lanes read neighbouring words
    at every step; shorter segments are padded with zeros that the
    kernel never reads. Mel m is then segment m's first sums plus
    segment m - 1's second sums. Raises if the filterbank is not banded
    like this."""
    mel = filters.mel_filterbank(Config.SAMPLE_RATE, Config.N_FFT, N_MELS)
    nz = mel != 0
    lowest = np.where(nz.any(axis=0), np.argmax(nz, axis=0), -1)
    first = np.zeros(N_MELS, np.int64)
    end = np.zeros(N_MELS, np.int64)
    for s in range(N_MELS):
        bins = np.nonzero(lowest == s)[0]
        if bins.size:
            first[s], end[s] = bins[0], bins[-1] + 1
            if end[s] - first[s] != bins.size:
                raise ValueError(f'mel segment {s} is not contiguous')
    off = np.zeros(N_MELS, np.int64)
    blocks, base = [], 0
    for g in range(0, N_MELS, 32):
        n = end[g:g + 32] - first[g:g + 32]
        block = np.zeros((int(n.max()), 32, 2), np.float32)
        for lane in range(len(n)):
            s = g + lane
            block[:n[lane], lane, 0] = mel[s, first[s]:end[s]]
            if s + 1 < N_MELS:
                block[:n[lane], lane, 1] = mel[s + 1, first[s]:end[s]]
            off[s] = base + lane
        blocks.append(block.reshape(-1))
        base += block.shape[0] * 32
    taps = np.concatenate(blocks)
    runs = np.stack([first, end, off]).astype(np.int32)
    if not np.array_equal(dense_from_taps(taps, runs), mel):
        raise ValueError('the mel filterbank is not two neighbouring mels a bin')
    return taps, runs


def dense_from_taps(taps: np.ndarray, runs: np.ndarray) -> np.ndarray:
    """The (M, F) filterbank that mel_taps' tables stand for."""
    pairs = taps.reshape(-1, 2)
    dense = np.zeros((N_MELS, N_BINS), np.float32)
    for s in range(N_MELS):
        first, end, off = (int(v) for v in runs[:, s])
        at = off + 32 * np.arange(end - first)
        dense[s, first:end] = pairs[at, 0]
        if s + 1 < N_MELS:
            dense[s + 1, first:end] += pairs[at, 1]
    return dense


@functools.lru_cache(maxsize=None)
def _kernel_tables(device: torch.device):
    """(taps, runs, dct) on `device`, and the tap count."""
    taps, runs = mel_taps()
    dct = filters.dct_matrix(N_MFCC, N_MELS)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (taps, runs, dct)) + (int(taps.size),)


def frame_split(B: int) -> int:
    """Blocks a clip (the cluster's size): a divisor of N_FRAMES, each
    block taking N_FRAMES / split whole frames, rank r the frames
    [r * N_FRAMES / split, (r + 1) * N_FRAMES / split). Ten blocks of 13
    frames spread a few clips over the most SMs; from 5 clips on, five
    blocks of 26 frames are as fast and keep the whole grid of a batch
    of 32 on the card at once."""
    return 10 if B <= 4 else 5


def mfcc_mean_plain(P: torch.Tensor) -> torch.Tensor:
    """(B, 130, 1025) power spectrogram -> (B, 40): P @ melT -> dB (clamp at
    the clip max - 80) -> @ dctT -> mean over frames, in fp32."""
    mel, _lo, _hi, dct = _mel_tables(P.device)
    melspec = P @ mel.T
    db = 10.0 * torch.log10(torch.clamp_min(melspec, 1e-10))
    clip_max = db.amax(dim=(1, 2), keepdim=True)
    db = torch.maximum(db, clip_max - 80.0)
    return (db @ dct.T).mean(dim=1)


def mfcc_mean(P: torch.Tensor) -> torch.Tensor:
    """(B, N_FRAMES, N_BINS) float32 power spectrogram -> (B, N_MFCC).

    Like mfcc_mean_pallas, rejects any frame count but the 130 of the
    fixed 3 s serving clip (the kernel's mean divisor is that constant)."""
    if P.dim() != 3 or P.shape[1:] != (N_FRAMES, N_BINS):
        raise ValueError(f'mfcc_mean requires (B, {N_FRAMES}, {N_BINS}), '
                         f'got {tuple(P.shape)}')
    if _build.on_cpu(P, 'mfcc_mean'):
        return mfcc_mean_plain(P)
    _build.check_cuda(P, 'mfcc_mean', torch.float32)
    taps, runs, dct, n_taps = _kernel_tables(P.device)
    B = P.shape[0]
    out = torch.empty((B, N_MFCC), dtype=torch.float32, device=P.device)
    with _build.device_of(P.device):
        err = _lib_mfcc().mec_mfcc_mean(
            P.data_ptr(), B, N_FRAMES, N_BINS, taps.data_ptr(), n_taps,
            runs.data_ptr(), dct.data_ptr(), frame_split(B), out.data_ptr(),
            _build.stream(P.device))
    _build.check_error(err, 'mfcc_mean')
    _build.count_launch(mfcc_mean)
    return out


mfcc_mean.launches = 0


# ----------------------------------------------------------------------
# K4: fully-fused speech DNN forward (inference, BN folded)
# ----------------------------------------------------------------------

def fold_batchnorm(variables: Dict) -> Dict[str, np.ndarray]:
    """Fold inference-mode BatchNorm into the Dense kernels/biases.

    A numpy copy of mec_tpu/ops/pallas_kernels.py::fold_batchnorm:
    y = gamma * (xW + b - mean) / sqrt(var + eps) + beta
      = x (W * gamma/sqrt(var+eps)) + ((b - mean) * gamma/sqrt(var+eps) + beta)
    Keras BatchNorm eps = 1e-3. Kernels keep the Flax (in, out) layout.
    """
    params = variables['params']
    stats = variables.get('batch_stats', {})
    folded = {}
    i = 0
    while f'dense_{i}' in params:
        W = np.asarray(params[f'dense_{i}']['kernel'], np.float32)
        b = np.asarray(params[f'dense_{i}']['bias'], np.float32)
        bn_p = params[f'bn_{i}']
        bn_s = stats[f'bn_{i}']
        gamma = np.asarray(bn_p['scale'], np.float32)
        beta = np.asarray(bn_p['bias'], np.float32)
        mean = np.asarray(bn_s['mean'], np.float32)
        var = np.asarray(bn_s['var'], np.float32)
        inv = gamma / np.sqrt(var + 1e-3)
        folded[f'W{i}'] = W * inv[None, :]
        folded[f'b{i}'] = (b - mean) * inv + beta
        i += 1
    folded['n_blocks'] = i
    folded['Wout'] = np.asarray(params['dense_out']['kernel'], np.float32)
    folded['bout'] = np.asarray(params['dense_out']['bias'], np.float32)
    return folded


def _folded_layers(folded: Dict) -> List[Tuple[np.ndarray, np.ndarray]]:
    n = folded['n_blocks']
    return ([(folded[f'W{i}'], folded[f'b{i}']) for i in range(n)]
            + [(folded['Wout'], folded['bout'])])


def speech_dnn_plain(x: torch.Tensor, params: torch.Tensor,
                     dims: Tuple[int, ...]) -> torch.Tensor:
    """The folded forward in plain fp32 torch, same packed (B, 128) row."""
    h, off = x, 0
    n_layers = len(dims) - 1
    for L in range(n_layers):
        din, dout = dims[L], dims[L + 1]
        W = params[off:off + din * dout].view(din, dout)
        b = params[off + din * dout:off + din * dout + dout]
        off += din * dout + dout
        h_next = h @ W + b
        if L + 1 < n_layers:
            penult = h_next = torch.relu(h_next)
        h = h_next
    probs = torch.softmax(h, dim=-1)
    n_cls = dims[-1]
    pen = min(dims[-2], PACKED_COLS - n_cls)
    out = torch.zeros((x.shape[0], PACKED_COLS), dtype=torch.float32,
                      device=x.device)
    out[:, :n_cls] = probs
    out[:, n_cls:n_cls + pen] = penult[:, :pen]
    return out


# K4's grid: a cluster of DNN_CLUSTER blocks for every DNN_ROWS rows (the
# kernel's kRows); each block computes 1 / DNN_CLUSTER of a hidden layer's
# columns
DNN_CLUSTER = 16
DNN_ROWS = 8


def dnn_grid(B: int) -> Tuple[int, int]:
    """(rows a tile, tiles) for a batch of B rows: one cluster per tile,
    the last tile may be ragged. In a tile, the block of rank r writes
    the packed rows i with i % DNN_CLUSTER == r."""
    return DNN_ROWS, -(-B // DNN_ROWS)


@functools.lru_cache(maxsize=None)
def _c_dims(dims: Tuple[int, ...]):
    return (_I * len(dims))(*dims)


def speech_dnn(x: torch.Tensor, params: torch.Tensor,
               dims: Tuple[int, ...]) -> torch.Tensor:
    """(B, dims[0]) float32 -> packed (B, 128) [probs | penult | zeros].

    params: the folded layers flattened as [W0 (din x dout), b0, ...,
    Wout, bout] (make_speech_dnn builds it); dims: layer widths."""
    if x.dim() != 2 or x.shape[1] != dims[0]:
        raise ValueError(f'speech_dnn: expected (B, {dims[0]}), '
                         f'got {tuple(x.shape)}')
    if _build.on_cpu(x, 'speech_dnn'):
        return speech_dnn_plain(x, params, dims)
    _build.check_cuda(x, 'speech_dnn', torch.float32)
    _build.check_cuda(params, 'speech_dnn params', torch.float32)
    B = x.shape[0]
    out = torch.empty((B, PACKED_COLS), dtype=torch.float32, device=x.device)
    with _build.device_of(x.device):
        err = _lib_dnn().mec_speech_dnn(
            x.data_ptr(), params.data_ptr(), _c_dims(dims), len(dims) - 1, B,
            DNN_CLUSTER, out.data_ptr(), _build.stream(x.device))
    _build.check_error(err, 'speech_dnn')
    _build.count_launch(speech_dnn)
    return out


speech_dnn.launches = 0


def make_speech_dnn(variables: Dict, device) -> Callable:
    """Fold the Flax {'params', 'batch_stats'} numpy tree once, place it
    on `device`; returns fn(x (B, 56)) -> (B, 128) packed
    [probs(7) | penult(64) | zeros], with .n_classes and .penult_dim."""
    layers = _folded_layers(fold_batchnorm(variables))
    dims = (layers[0][0].shape[0],) + tuple(W.shape[1] for W, _ in layers)
    flat = np.concatenate([a.ravel() for W, b in layers for a in (W, b)])
    params = torch.from_numpy(flat.astype(np.float32)).to(device)
    c_dims = _c_dims(dims)       # built here once, looked up by every call

    def forward(x: torch.Tensor) -> torch.Tensor:
        return speech_dnn(x, params, dims)

    forward.n_classes = dims[-1]
    forward.penult_dim = dims[-2]
    forward.params, forward.dims = params, dims   # for checks vs the plain twin
    forward.c_dims = c_dims
    return forward
