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

The kernel gives a warp a row: `rows_per_block(R)` warps a block, each
with a shared-memory buffer of `row_buffer_floats` floats, and lane l
the bins `lane_bins(F)[l]`. The geometry is computed
here and pinned by the CPU tests.
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
                                     ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p]
    lib.mec_rolloff_bins.restype = ctypes.c_int
    return lib


MAX_ROWS_PER_BLOCK = 8


def rows_per_block(R: int) -> int:
    """Rows (warps) a block: as many as still leave a block for every SM,
    at most MAX_ROWS_PER_BLOCK: 1 for the 130 rows of one clip, 7 for
    eight clips, 8 from ten clips on. The launch has ceil(R / rows)
    blocks; the last block's spare warps leave at once."""
    return max(1, min(MAX_ROWS_PER_BLOCK, R // _build.SM_COUNT))


def row_buffer_floats(F: int) -> int:
    """A warp's buffer: the row's F floats placed up to 3 floats in, so
    that the buffer and the source share their 16-byte phase, in whole
    16-byte units."""
    return (F + 3 + 3) // 4 * 4


def lane_bins(F: int):
    """[lo, hi) of the consecutive bins each of a warp's 32 lanes owns:
    ceil(F / 32) a lane (33 of 1025), the last lanes fewer or none."""
    per = -(-F // 32)
    return [(min(l * per, F), min((l + 1) * per, F)) for l in range(32)]


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
    with _build.device_of(mag2d.device):
        err = _lib().mec_rolloff_bins(mag2d.data_ptr(), R, F, roll_percent,
                                      rows_per_block(R), out.data_ptr(),
                                      _build.stream(mag2d.device))
    _build.check_error(err, 'rolloff_bins')
    _build.count_launch(rolloff_bins)
    return out


rolloff_bins.launches = 0
