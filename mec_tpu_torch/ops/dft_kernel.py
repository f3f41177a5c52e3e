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

The kernel cuts the 1024 bins below the Nyquist bin into tiles and
handles the Nyquist bin beside them; `tile_grid` picks the tile from the
row count, and `kernel_tables` lays the bases out as the kernel reads
them: fp32 (2048, 1024) plus the Nyquist columns for 'highest' (fp32
FMAs), bf16 K-major (1032, 2048) for 'bf16' (tensor cores: mma.sync
m16n8k16, which needs sm_80 or later; the build targets sm_90a).
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
    lib.mec_dft_power.argtypes = [P, P, P, P, I, I, I, I, I, I, P, P, P]
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


N_TILED = N_BINS - 1              # 1024 bins in tiles; bin 1024 beside them
N_PAD = N_BINS + 7                # bf16 table rows: a multiple of 8
TILES = ((128, 64), (32, 32))     # (frames, bins) a block, largest first


def tile_grid(m: int, n: int = N_BINS) -> Tuple[int, int, int, int]:
    """(bm, bn, grid_x, grid_y) for m rows and n bins: the largest tile
    of TILES that still gives every SM a block, else the smallest. The
    grid covers the n - 1 bins below the Nyquist bin; `nyquist_rows`
    deals out the last one."""
    for bm, bn in TILES:
        gx, gy = (n - 1) // bn, -(-m // bm)
        if gx * gy >= _build.SM_COUNT:
            break
    return bm, bn, gx, gy


def nyquist_rows(m: int, bm: int, gx: int, bx: int, by: int) -> range:
    """The rows whose Nyquist bin block (bx, by) computes: the row
    tile's bm rows dealt out to its gx blocks (csrc/dft_power.cu::
    nyquist_bin)."""
    per = -(-bm // gx)
    lo = by * bm + bx * per
    return range(min(lo, m), min(by * bm + min((bx + 1) * per, bm), m))


@functools.lru_cache(maxsize=None)
def kernel_tables(device: torch.device, precision: str
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bases of `_bases` as the kernel reads them: (cos, sin, nyq).

    'highest': cos, sin (N_FFT, N_TILED) fp32 (16-byte aligned rows) and
    nyq (2, N_FFT) fp32, the Nyquist bin's cos and sin columns.
    'bf16': cos, sin (N_PAD, N_FFT) bf16, K-major (row n is bin n), rows
    past N_BINS zero; nyq is an empty tensor (row N_TILED serves)."""
    cos, sin = _bases(device, precision)
    if precision == 'bf16':
        pad = torch.zeros((N_PAD - N_BINS, N_FFT), dtype=torch.bfloat16,
                          device=device)
        cosT, sinT = (torch.cat([t.t().to(torch.bfloat16), pad]).contiguous()
                      for t in (cos, sin))
        return cosT, sinT, torch.empty(0, device=device)
    nyq = torch.stack([cos[:, N_TILED], sin[:, N_TILED]]).contiguous()
    return (cos[:, :N_TILED].contiguous(), sin[:, :N_TILED].contiguous(),
            nyq)


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
                         '16-byte boundary (the kernel copies 16 bytes)')
    B, T, _ = frames.shape
    cos, sin, nyq = kernel_tables(frames.device, precision)
    bm, bn, _gx, _gy = tile_grid(B * T)
    P = torch.empty((B, T, N_BINS), dtype=torch.float32,
                    device=frames.device)
    mag = torch.empty_like(P)
    with _build.device_of(frames.device):
        err = _lib().mec_dft_power(
            frames.data_ptr(), cos.data_ptr(), sin.data_ptr(), nyq.data_ptr(),
            B * T, N_FFT, N_BINS, int(precision == 'bf16'), bm, bn,
            P.data_ptr(), mag.data_ptr(), _build.stream(frames.device))
    _build.check_error(err, 'dft_spectrograms')
    _build.count_launch(dft_spectrograms)
    return mag, P


dft_spectrograms.launches = 0
