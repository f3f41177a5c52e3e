"""MobileNetV2 image emotion model: the port of mec_tpu/models/mobilenet.py.

torchvision's MobileNetV2 graph (width 1.0) with the reference's head,
so the 512-dim head feature feeds the fusion net as ResNet50's does:

    stem: conv3x3/2 (32) -> BN -> ReLU6 -> 17 inverted residuals
    head: conv_head 1x1 (1280) -> BN -> ReLU6 -> global mean
          -> Linear(1280, 512) -> ReLU -> Linear(512, 7)

An inverted residual is expand 1x1 (when t > 1) -> BN -> ReLU6 ->
depthwise 3x3 (stride s, padding 1) -> BN -> ReLU6 -> project 1x1 ->
BN, plus the input when s == 1 and the widths match. Returns (logits
f32, the post-ReLU head feature f32); dropouts are identity at
inference.

NHWC activations, the JAX package's layout; convs run F.conv2d on the
channels-last view (models/resnet.ConvNHWC, which takes the depthwise
conv's groups). Submodule names are the Flax ones (conv_stem, bn_stem,
block_{i}.expand_conv, .dw_conv, .project_conv with their _bn, conv_head,
bn_head, fc1, fc2), so convert/from_jax.mobilenet_state_from_jax loads
the Flax tree. Three forms, one per serving mode:

  * fp32 parity: convs without bias + live BatchNorm (eps 1e-5);
  * fold_bn: BN folded into biased convs (ops/fold.py), compute dtype;
  * fold_bn + quant: the 1x1 expand and project convs and conv_head as
    int8 QuantConv ('dynamic' or 'static' scales); conv_stem, the
    depthwise 3x3s and fc1/fc2 stay in the compute dtype, as
    ops/quant.py decides (_SKIP_TOP, _is_folded_conv).

Biases are added after the conv or matmul in the compute dtype, and the
global mean is taken in f32 and cast back, as Flax does. No kernel is
hand-written here: the JAX package computes MobileNetV2 outside Pallas.
Training (module.training, the live-BN form only) is ResNet50's:
Flax's BatchNorm step (momentum 0.9), head dropouts 0.5 and 0.3, and
with remat=True each inverted residual recomputed in the backward pass.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mec_tpu_torch.models.batchnorm import remat
from mec_tpu_torch.models.qconv import QuantConv
from mec_tpu_torch.models.resnet import BN_EPS, BatchNormNHWC, ConvNHWC

# torchvision mobilenet_v2 inverted-residual settings (t, c, n, s)
INVERTED_RESIDUAL_CFG: Sequence[Tuple[int, int, int, int]] = (
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


def _conv(parent: nn.Module, name: str, cin: int, cout: int, k: int,
          stride: int = 1, groups: int = 1, quant: bool = False) -> None:
    """Add conv `name` (and, without fold_bn, its BN) to parent."""
    pad = (k - 1) // 2
    if quant:
        conv = QuantConv(cin, cout, k, stride, pad, parent.quant_mode,
                         parent.dtype)
    else:
        conv = ConvNHWC(cin, cout, k, stride, pad, groups=groups,
                        bias=parent.fold_bn, dtype=parent.dtype)
    parent.add_module(name, conv)
    if not parent.fold_bn:
        parent.add_module(name.replace('conv', 'bn'),
                          BatchNormNHWC(cout, eps=BN_EPS))


def _apply(parent: nn.Module, name: str, x: torch.Tensor) -> torch.Tensor:
    """conv `name`, then its BN unless folded."""
    x = getattr(parent, name)(x)
    if parent.fold_bn:
        return x
    return getattr(parent, name.replace('conv', 'bn'))(x)


class InvertedResidual(nn.Module):
    """expand(1x1) -> depthwise(3x3, stride) -> project(1x1, linear)."""

    def __init__(self, cin: int, cout: int, stride: int, expand: int, *,
                 dtype=torch.float32, fold_bn: bool = False,
                 quant: bool = False, quant_mode: str = 'dynamic'):
        super().__init__()
        self.dtype, self.fold_bn, self.quant_mode = dtype, fold_bn, quant_mode
        self.residual = stride == 1 and cin == cout
        hidden = cin * expand
        self.has_expand = expand != 1
        if self.has_expand:
            _conv(self, 'expand_conv', cin, hidden, 1, quant=quant)
        # the depthwise conv is never quantized (ops/quant._is_folded_conv)
        _conv(self, 'dw_conv', hidden, hidden, 3, stride, groups=hidden)
        _conv(self, 'project_conv', hidden, cout, 1, quant=quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x
        if self.has_expand:
            out = F.relu6(_apply(self, 'expand_conv', out))
        out = F.relu6(_apply(self, 'dw_conv', out))
        out = _apply(self, 'project_conv', out)
        return out + x if self.residual else out


class MobileNetV2EmotionModel(nn.Module):
    def __init__(self, num_classes: int = 7,
                 dtype: torch.dtype = torch.float32, fold_bn: bool = False,
                 quant: bool = False, quant_mode: str = 'dynamic',
                 remat: bool = False):
        super().__init__()
        if quant and not fold_bn:
            raise ValueError('quant requires fold_bn (BN-folded params)')
        self.dtype, self.fold_bn = dtype, fold_bn
        self.quant, self.quant_mode, self.remat = quant, quant_mode, remat
        _conv(self, 'conv_stem', 3, 32, 3, 2)
        self.blocks = []
        idx, cin = 1, 32
        for t, c, n, s in INVERTED_RESIDUAL_CFG:
            for i in range(n):
                name = f'block_{idx}'
                self.add_module(name, InvertedResidual(
                    cin, c, s if i == 0 else 1, t, dtype=dtype,
                    fold_bn=fold_bn, quant=quant, quant_mode=quant_mode))
                self.blocks.append(name)
                cin = c
                idx += 1
        _conv(self, 'conv_head', cin, 1280, 1, quant=quant)
        self.fc1 = nn.Linear(1280, 512, dtype=dtype)
        self.fc2 = nn.Linear(512, num_classes, dtype=dtype)
        self.dropout_1 = nn.Dropout(0.5)
        self.dropout_2 = nn.Dropout(0.3)
        self.eval()    # the Flax models' train=False default

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, H, W, 3) ImageNet-normalized NHWC (H, W >= 32) ->
        (logits (B, 7) f32, head features (B, 512) f32)."""
        if self.training and self.fold_bn:
            raise ValueError('fold_bn is inference-only')
        x = F.relu6(_apply(self, 'conv_stem', x.to(self.dtype)))
        for name in self.blocks:
            blk = getattr(self, name)
            x = remat(blk, x) if self.remat and self.training else blk(x)
        x = F.relu6(_apply(self, 'conv_head', x))
        x = x.float().mean(dim=(1, 2)).to(self.dtype)
        x = self.dropout_1(x)
        feat = F.relu(F.linear(x, self.fc1.weight) + self.fc1.bias)
        logits = (F.linear(self.dropout_2(feat), self.fc2.weight)
                  + self.fc2.bias)
        return logits.float(), feat.float()
