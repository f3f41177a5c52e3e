"""K7 layer1: ResNet50 layer1 (three bottleneck blocks, ten int8 convs) in
QuantConv static numerics, on NHWC bf16 maps.

The counterpart of mec_tpu/ops/pallas_resnet.py. `layer1(x, blocks)`
takes the pooled stem output (B, H, W, 64) bf16 and the model's three
layer1 Bottleneck modules (models/resnet.py, static-mode QuantConvs). For
a CPU tensor it runs the plain version, the blocks themselves (im2col +
torch._int_mm per conv); for a CUDA tensor it launches the kernels of
csrc/layer1_int8.cu (one quantize and ten conv launches behind one C
call, counted once in `layer1.launches`) or raises. The two are
bit-exact: the integer sums are exact and both round at the same points
(the source's header lists them).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence

import torch
from torch import nn

from mec_tpu_torch.models.qconv import QuantConv
from mec_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_PTRS = _P * 10

# the TPU kernel's conv order (mec_tpu/ops/pallas_resnet.py::_CONV_ORDER)
CONV_ORDER = ((0, 'conv1'), (0, 'conv2'), (0, 'conv3'),
              (0, 'downsample_conv'),
              (1, 'conv1'), (1, 'conv2'), (1, 'conv3'),
              (2, 'conv1'), (2, 'conv2'), (2, 'conv3'))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.library()
    lib.mec_layer1_int8.argtypes = [_P, _I, _I, _I, _PTRS, _PTRS, _PTRS, _P,
                                    _P, _P, _P, _P, _P, _P, _P, _P]
    lib.mec_layer1_int8.restype = _I
    return lib


def layer1_plain(x: torch.Tensor, blocks: Sequence[nn.Module]) -> torch.Tensor:
    for blk in blocks:
        x = blk(x)
    return x


def _convs(blocks: Sequence[nn.Module]) -> List[nn.Module]:
    """The ten QuantConvs in CONV_ORDER; raises unless they are layer1's
    static int8 convs (1x1 and 3x3, stride 1, 64/256 channels)."""
    if len(blocks) != 3:
        raise ValueError(f'layer1: expected 3 blocks, got {len(blocks)}')
    convs = [getattr(blocks[b], name, None) for b, name in CONV_ORDER]
    for (b, name), c in zip(CONV_ORDER, convs):
        cin = 64 if b == 0 or name != 'conv1' else 256
        cout = 256 if name in ('conv3', 'downsample_conv') else 64
        k = 3 if name == 'conv2' else 1
        if not (isinstance(c, QuantConv) and c.mode == 'static'
                and c.stride == 1 and c.k == k and c.cin == cin
                and c.cout == cout and c.dtype == torch.bfloat16):
            raise ValueError(f'layer1: block {b} {name} is not a static '
                             f'bf16 QuantConv {cin}->{cout} k{k} s1')
    return convs


def layer1(x: torch.Tensor, blocks: Sequence[nn.Module]) -> torch.Tensor:
    """(B, H, W, 64) bf16 NHWC -> (B, H, W, 256) bf16."""
    if x.dim() != 4 or x.shape[-1] != 64:
        raise ValueError(f'layer1: expected (B, H, W, 64), '
                         f'got {tuple(x.shape)}')
    if _build.on_cpu(x, 'layer1'):
        return layer1_plain(x, blocks)
    _build.check_cuda(x, 'layer1', torch.bfloat16)
    if x.data_ptr() % 16:
        raise ValueError('layer1: the kernel takes 16-byte aligned rows')
    convs = _convs(blocks)
    for c in convs:
        for name in ('kernel_q', 'kernel_scale', 'bias', 'act_scale'):
            t = getattr(c, name)
            if t.device != x.device or not t.is_contiguous():
                raise ValueError(f'layer1: {name} not contiguous on '
                                 f'{x.device}')
    B, H, W, _ = x.shape
    M = B * H * W
    dev = x.device
    scales = torch.stack([c.act_scale for c in convs])
    i8 = dict(dtype=torch.int8, device=dev)
    qa, qd, h1q, h2q = (torch.empty((M, 64), **i8) for _ in range(4))
    resq = torch.empty((M, 256), **i8)
    ident = torch.empty((M, 256), dtype=torch.bfloat16, device=dev)
    out = torch.empty((B, H, W, 256), dtype=torch.bfloat16, device=dev)
    err = _lib().mec_layer1_int8(
        x.data_ptr(), B, H, W,
        _PTRS(*(c.kernel_q.data_ptr() for c in convs)),
        _PTRS(*(c.kernel_scale.data_ptr() for c in convs)),
        _PTRS(*(c.bias.data_ptr() for c in convs)),
        scales.data_ptr(), qa.data_ptr(), qd.data_ptr(), h1q.data_ptr(),
        h2q.data_ptr(), resq.data_ptr(), ident.data_ptr(), out.data_ptr(),
        _build.stream(dev))
    _build.check_error(err, 'layer1')
    _build.count_launch(layer1)
    return out


layer1.launches = 0
