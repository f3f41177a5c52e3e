"""Speech-path kernels K1 (mfcc_mean) and K4 (the fused speech DNN).

The counterpart of mec_tpu/ops/pallas_kernels.py. Each wrapper checks
its input, runs the plain PyTorch version for a CPU tensor, and for a
CUDA tensor launches its hand-written kernel (csrc/mfcc_mean.cu,
csrc/speech_dnn.cu) or raises; it never falls back. `wrapper.launches`
counts the kernel launches, so a run can show that the serving path went
through the kernels.
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
    lib.mec_mfcc_mean.argtypes = [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P]
    lib.mec_mfcc_mean.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _lib_dnn():
    lib = _build.library()
    lib.mec_speech_dnn.argtypes = [_P, _P, ctypes.POINTER(_I), _I, _I, _P, _P]
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
    mel, lo, hi, dct = _mel_tables(P.device)
    B = P.shape[0]
    out = torch.empty((B, N_MFCC), dtype=torch.float32, device=P.device)
    err = _lib_mfcc().mec_mfcc_mean(
        P.data_ptr(), B, N_FRAMES, N_BINS, mel.data_ptr(), lo.data_ptr(),
        hi.data_ptr(), dct.data_ptr(), out.data_ptr(),
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
    c_dims = (_I * len(dims))(*dims)
    err = _lib_dnn().mec_speech_dnn(
        x.data_ptr(), params.data_ptr(), c_dims, len(dims) - 1, B,
        out.data_ptr(), _build.stream(x.device))
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

    def forward(x: torch.Tensor) -> torch.Tensor:
        return speech_dnn(x, params, dims)

    forward.n_classes = dims[-1]
    forward.penult_dim = dims[-2]
    forward.params, forward.dims = params, dims   # for checks vs the plain twin
    return forward
