"""K7 layer1: ResNet50 layer1 (three bottleneck blocks, ten int8 convs) in
QuantConv static numerics, on NHWC bf16 maps.

The counterpart of mec_tpu/ops/pallas_resnet.py. `layer1(x, blocks)`
takes the pooled stem output (B, H, W, 64) bf16 and the model's three
layer1 Bottleneck modules (models/resnet.py, static-mode QuantConvs). For
a CPU tensor it runs the plain version, the blocks themselves (im2col +
torch._int_mm per conv); for a CUDA tensor it launches the kernels of
csrc/layer1_int8.cu (seven launches behind one C call, counted once in
`layer1.launches`) or raises. The two are bit-exact: the integer sums
are exact and both round at the same points (the source's header lists
them).

The convs run on the int8 tensor cores (mma.sync m16n8k32, sm_80 or
later; the build targets sm_90a). The instruction's `row.col` form is
how the operands already lie (pixels with channels fastest, weights
(Cout, kh*kw*Cin)), so no weight is repacked: the kernel reads the
QuantConv buffers in place, and the ten activation scales through their
own pointers, so a model recalibrated in place needs no new wrapper
state. The checked conv list and the four pointer tables are kept per
model (keyed on its first block) for as long as the blocks still hold
the very tensors that were checked. `pixel_tile` picks the pixels a
block takes from the pixel count.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
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
    lib.mec_layer1_int8.argtypes = [_P, _I, _I, _I, _PTRS, _PTRS, _PTRS,
                                    _PTRS, _P, _P, _I, _P]
    lib.mec_layer1_int8.restype = _I
    return lib


PIXEL_TILES = (128, 16)           # pixels a block, largest first
SCRATCH_BYTES = 64 + 64           # int8 maps between launches, per pixel


def pixel_tile(m: int) -> int:
    """The pixels a block takes for a map of m pixels: the largest of
    PIXEL_TILES that still gives every SM a block, else the smallest."""
    for tile in PIXEL_TILES:
        if -(-m // tile) >= _build.SM_COUNT:
            break
    return tile


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


_BUFFERS = ('kernel_q', 'kernel_scale', 'bias', 'act_scale')
# first block -> (the three blocks, device, [(conv._buffers, name, tensor)],
# the four pointer tables)
_tables = weakref.WeakKeyDictionary()


def _pointer_tables(blocks: Sequence[nn.Module], device: torch.device):
    """Four ctypes tables of ten device pointers (weights, kernel scales,
    biases, activation scales, in CONV_ORDER), checked once per model."""
    hit = _tables.get(blocks[0]) if len(blocks) == 3 else None
    if hit is not None:
        owners, dev, held, tables = hit
        if (dev == device and all(a is b for a, b in zip(owners, blocks))
                and all(bufs.get(name) is t for bufs, name, t in held)):
            return tables
    convs = _convs(blocks)
    held = []
    for c in convs:
        for name in _BUFFERS:
            t = getattr(c, name)
            # the weights are copied 16 bytes at a time
            if (t.device != device or not t.is_contiguous()
                    or (name == 'kernel_q' and t.data_ptr() % 16)):
                raise ValueError(f'layer1: {name} not contiguous (and, the '
                                 f'weights, 16-byte aligned) on {device}')
            held.append((c._buffers, name, t))
    tables = tuple(_PTRS(*(getattr(c, name).data_ptr() for c in convs))
                   for name in _BUFFERS)
    _tables[blocks[0]] = (tuple(blocks), device, held, tables)
    return tables


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
    B, H, W, _ = x.shape
    M = B * H * W
    dev = x.device
    wq, kscale, bias, ascale = _pointer_tables(blocks, dev)
    scratch = torch.empty(M * SCRATCH_BYTES, dtype=torch.int8, device=dev)
    out = torch.empty((B, H, W, 256), dtype=torch.bfloat16, device=dev)
    with _build.device_of(dev):
        err = _lib().mec_layer1_int8(
            x.data_ptr(), B, H, W, wq, kscale, bias, ascale,
            scratch.data_ptr(), out.data_ptr(), pixel_tile(M),
            _build.stream(dev))
    _build.check_error(err, 'layer1')
    _build.count_launch(layer1)
    return out


layer1.launches = 0
