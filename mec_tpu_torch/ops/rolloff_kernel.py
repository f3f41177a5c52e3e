"""K3 rolloff_bins: the spectral-rolloff crossing bin of each magnitude row.

The counterpart of mec_tpu/ops/pallas_rolloff.py: per row, the lowest
bin k whose prefix sum reaches roll_percent of the row total (an
all-zero row gives bin 0). The serving frontend maps bins to Hz as
bin * 11025 * 2**-10, exact in f32.

The wrapper runs the plain version (torch.cumsum and the first index
that reaches the threshold) for a CPU tensor and launches the warp-scan
kernel (csrc/rolloff_bins.cu) for a CUDA tensor, or raises;
`rolloff_bins.launches` counts kernel launches. The two sum in different
orders, so a bin may differ by one on a near-tie (|prefix - threshold|
within rounding); continuous spectra make that a measure-zero event.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mec_tpu_torch.ops import _build


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.library()
    lib.mec_rolloff_bins.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_float,
                                     ctypes.c_void_p, ctypes.c_void_p]
    lib.mec_rolloff_bins.restype = ctypes.c_int
    return lib


def rolloff_bins_plain(mag2d: torch.Tensor,
                       roll_percent: float = 0.85) -> torch.Tensor:
    cum = torch.cumsum(mag2d, dim=-1)
    hit = cum >= roll_percent * cum[:, -1:]
    first = torch.argmax(hit.to(torch.uint8), dim=-1)     # first True
    last = torch.full_like(first, mag2d.shape[-1] - 1)
    return torch.where(hit.any(dim=-1), first, last).to(torch.int32)


def rolloff_bins(mag2d: torch.Tensor, roll_percent: float = 0.85
                 ) -> torch.Tensor:
    """(R, F) float32 magnitude rows -> (R,) int32 crossing bins."""
    if mag2d.dim() != 2:
        raise ValueError(f'rolloff_bins: expected (R, F), '
                         f'got {tuple(mag2d.shape)}')
    if _build.on_cpu(mag2d, 'rolloff_bins'):
        return rolloff_bins_plain(mag2d, roll_percent)
    _build.check_cuda(mag2d, 'rolloff_bins', torch.float32)
    R, F = mag2d.shape
    out = torch.empty(R, dtype=torch.int32, device=mag2d.device)
    err = _lib().mec_rolloff_bins(mag2d.data_ptr(), R, F, roll_percent,
                                  out.data_ptr(),
                                  _build.stream(mag2d.device))
    _build.check_error(err, 'rolloff_bins')
    _build.count_launch(rolloff_bins)
    return out


rolloff_bins.launches = 0
