"""K6 max_pool_3x3s2: the 3x3 / stride 2 / pad 1 max-pool after the
ResNet50 stem, on NHWC bf16 maps.

The counterpart of mec_tpu/ops/pallas_pool.py. The wrapper runs the
plain version (F.max_pool2d on the channels-last view) for a CPU tensor
and launches the CUDA kernel (csrc/max_pool_3x3s2.cu) for a CUDA tensor,
or raises; `max_pool_3x3s2.launches` counts kernel launches. The two are
bit-exact: a max moves values, it computes none.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from mec_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.library()
    lib.mec_max_pool_3x3s2.argtypes = [_P, _I, _I, _I, _I, _P, _P]
    lib.mec_max_pool_3x3s2.restype = _I
    return lib


def max_pool_3x3s2_plain(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, ceil(H/2), ceil(W/2), C); -inf padding."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def max_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) bf16 NHWC -> (B, ceil(H/2), ceil(W/2), C) bf16."""
    if x.dim() != 4:
        raise ValueError(f'max_pool_3x3s2: expected (B, H, W, C), '
                         f'got {tuple(x.shape)}')
    if _build.on_cpu(x, 'max_pool_3x3s2'):
        return max_pool_3x3s2_plain(x)
    _build.check_cuda(x, 'max_pool_3x3s2', torch.bfloat16)
    B, H, W, C = x.shape
    if C % 8 or x.data_ptr() % 16:
        raise ValueError('max_pool_3x3s2: the kernel takes C % 8 == 0 and '
                         '16-byte aligned rows')
    out = torch.empty((B, (H + 1) // 2, (W + 1) // 2, C),
                      dtype=torch.bfloat16, device=x.device)
    with _build.device_of(x.device):
        err = _lib().mec_max_pool_3x3s2(x.data_ptr(), B, H, W, C,
                                        out.data_ptr(),
                                        _build.stream(x.device))
    _build.check_error(err, 'max_pool_3x3s2')
    _build.count_launch(max_pool_3x3s2)
    return out


max_pool_3x3s2.launches = 0
