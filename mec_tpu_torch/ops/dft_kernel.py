"""K5 dft_spectrograms: windowed frames -> (magnitude, power) spectrograms.

The counterpart of mec_tpu/ops/pallas_kernels.py::dft_spectrograms, on
the framed speech frontend (Config.DFT_PRECISION 'highest' or 'bf16'):
(B, T, 2048) Hann-windowed fp32 frames times the (2048, 1025) cos/sin
DFT bases, then P = re^2 + im^2 and mag = sqrt(P), each (B, T, 1025)
fp32. Precisions:

  'highest'  fp32 operands, fp32 sums (no TF32);
  'bf16'     frames and bases rounded to bf16 (RNE, as astype does),
             products summed in fp32: the TPU kernel's one-pass bf16
             precision. bf16 x bf16 products are exact in fp32, so the
             kernel and the plain version differ only in summation order.

The wrapper runs the plain version (two fp32 torch.matmul on the
rounded operands) for a CPU tensor and launches the CUDA kernel
(csrc/dft_power.cu) for a CUDA tensor, or raises;
`dft_spectrograms.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from mec_tpu_torch.config import Config
from mec_tpu_torch.ops import _build

N_FFT = Config.N_FFT              # 2048
N_BINS = 1 + N_FFT // 2           # 1025
PRECISIONS = ('highest', 'bf16')


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.library()
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.mec_dft_power.argtypes = [P, P, P, I, I, I, I, P, P, P]
    lib.mec_dft_power.restype = I
    return lib


@functools.lru_cache(maxsize=None)
def _bases(device: torch.device, precision: str
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin DFT bases (N_FFT, N_BINS) fp32 on `device`; for 'bf16'
    their values are rounded to bf16 (kept in fp32 storage)."""
    n = np.arange(N_FFT)[:, None]
    k = np.arange(N_BINS)[None, :]
    ang = 2.0 * np.pi * n * k / N_FFT
    out = []
    for a in (np.cos(ang), -np.sin(ang)):
        t = torch.from_numpy(a.astype(np.float32))
        if precision == 'bf16':
            t = t.to(torch.bfloat16).to(torch.float32)
        out.append(t.to(device).contiguous())
    return tuple(out)


def _check(frames: torch.Tensor, precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f'dft_spectrograms precision {precision!r}: '
                         f'expected one of {PRECISIONS}')
    if frames.dim() != 3 or frames.shape[-1] != N_FFT:
        raise ValueError(f'dft_spectrograms: expected (B, T, {N_FFT}), '
                         f'got {tuple(frames.shape)}')


def dft_spectrograms_plain(frames: torch.Tensor, precision: str = 'highest'
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain fp32 torch: two matmuls on the
    (bf16-rounded, for 'bf16') operands, then P and sqrt."""
    _check(frames, precision)
    B, T, _ = frames.shape
    cos, sin = _bases(frames.device, precision)
    flat = frames.reshape(B * T, N_FFT).to(torch.float32)
    if precision == 'bf16':
        flat = flat.to(torch.bfloat16).to(torch.float32)
    re, im = flat @ cos, flat @ sin
    P = (re * re + im * im).reshape(B, T, N_BINS)
    return torch.sqrt(P), P


def dft_spectrograms(frames: torch.Tensor, precision: str = 'highest'
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, 2048) float32 windowed frames -> (mag, P), each
    (B, T, 1025) float32."""
    _check(frames, precision)
    if _build.on_cpu(frames, 'dft_spectrograms'):
        return dft_spectrograms_plain(frames, precision)
    _build.check_cuda(frames, 'dft_spectrograms', torch.float32)
    if frames.data_ptr() % 16:
        raise ValueError('dft_spectrograms: the frames must start on a '
                         '16-byte boundary (the kernel reads float4)')
    B, T, _ = frames.shape
    cos, sin = _bases(frames.device, precision)
    P = torch.empty((B, T, N_BINS), dtype=torch.float32,
                    device=frames.device)
    mag = torch.empty_like(P)
    err = _lib().mec_dft_power(
        frames.data_ptr(), cos.data_ptr(), sin.data_ptr(), B * T, N_FFT,
        N_BINS, int(precision == 'bf16'), P.data_ptr(), mag.data_ptr(),
        _build.stream(frames.device))
    _build.check_error(err, 'dft_spectrograms')
    _build.count_launch(dft_spectrograms)
    return mag, P


dft_spectrograms.launches = 0
