"""ResNet50 image emotion model: the port of mec_tpu/models/resnet.py.

torchvision's ResNet50 v1 graph with the reference's head:

    stem: conv7x7/2 -> BN -> ReLU -> maxpool 3x3/2 -> [3,4,6,3] bottlenecks
    head: global mean -> Linear(2048,512) -> ReLU -> Linear(512, 7)

returning (logits f32, the 512-dim post-ReLU head feature f32), as the
Flax model does (dropouts are identity at inference).

Activations are NHWC (B, H, W, C) tensors, the JAX package's layout; a
float conv runs F.conv2d on the channels-last NCHW view, so nothing is
copied. Three forms, one per serving mode, each taking the parameters of
convert/from_jax.image_state_from_jax:

  * fp32 parity: convs without bias + live BatchNorm (eps 1e-5);
  * fold_bn: BN folded into biased convs (ops/fold.py), compute dtype;
  * fold_bn + quant: the 52 bottleneck convs as int8 QuantConv
    ('dynamic' or 'static' activation scales); stem and head stay in
    the compute dtype.

Biases are added after the conv or matmul in the compute dtype, and the
global mean is taken in f32 and cast back, as Flax does. In bf16 the
stem pool is K6 (ops/pool_kernel.max_pool_3x3s2) and, with static int8,
layer1 is K7 (ops/resnet_kernel.layer1); on the CPU both run their
plain versions, on CUDA their kernels.

Training (module.training, the live-BN form only; the folded and int8
forms raise): the BatchNorms normalise with the batch statistics and
take Flax's update (models/batchnorm.train_batch_norm, momentum 0.9),
the stem pool is F.max_pool2d (K6 and K7 have no backward; Flax trains
through nn.max_pool), the head's dropouts are 0.5 before fc1 and 0.3
before fc2, and with remat=True each bottleneck is recomputed in the
backward pass (models/batchnorm.remat). For bf16 training the caller
runs the fp32 model under torch.autocast.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mec_tpu_torch.models.batchnorm import remat, train_batch_norm
from mec_tpu_torch.models.qconv import QuantConv
from mec_tpu_torch.ops import pool_kernel, resnet_kernel

BN_EPS = 1e-5


class ConvNHWC(nn.Conv2d):
    """nn.Conv2d on NHWC activations (grouped too: MobileNetV2's
    depthwise convs); a bias is added after the conv, in the compute
    dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, None, self.stride,
                     self.padding, 1, self.groups).permute(0, 2, 3, 1)
        return y if self.bias is None else y + self.bias


class BatchNormNHWC(nn.BatchNorm2d):
    """BatchNorm on NHWC activations: the running statistics in eval
    mode, Flax's training step in training mode."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return train_batch_norm(self, x)
        y = F.batch_norm(x.permute(0, 3, 1, 2).float(), self.running_mean,
                         self.running_var, self.weight, self.bias, False,
                         0.0, self.eps)
        return y.permute(0, 2, 3, 1).to(x.dtype)


def _conv(cin, cout, k, stride, pad, *, fold_bn, quant, quant_mode, dtype):
    if quant:
        return QuantConv(cin, cout, k, stride, pad, quant_mode, dtype)
    return ConvNHWC(cin, cout, k, stride, pad, bias=fold_bn, dtype=dtype)


class Bottleneck(nn.Module):
    """torchvision Bottleneck (expansion 4, stride on the 3x3 conv).
    Submodule names follow the Flax tree: conv1/bn1 .. conv3/bn3,
    downsample_conv/downsample_bn."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False, *, dtype=torch.float32,
                 fold_bn: bool = False, quant: bool = False,
                 quant_mode: str = 'dynamic'):
        super().__init__()
        kw = dict(fold_bn=fold_bn, quant=quant, quant_mode=quant_mode,
                  dtype=dtype)
        f = features
        self.fold_bn = fold_bn
        self.conv1 = _conv(cin, f, 1, 1, 0, **kw)
        self.conv2 = _conv(f, f, 3, stride, 1, **kw)
        self.conv3 = _conv(f, 4 * f, 1, 1, 0, **kw)
        if not fold_bn:
            self.bn1 = BatchNormNHWC(f, eps=BN_EPS)
            self.bn2 = BatchNormNHWC(f, eps=BN_EPS)
            self.bn3 = BatchNormNHWC(4 * f, eps=BN_EPS)
        self.has_downsample = downsample
        if downsample:
            self.downsample_conv = _conv(cin, 4 * f, 1, stride, 0, **kw)
            if not fold_bn:
                self.downsample_bn = BatchNormNHWC(4 * f, eps=BN_EPS)

    def _bn(self, name: str, h: torch.Tensor) -> torch.Tensor:
        return h if self.fold_bn else getattr(self, name)(h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self._bn('bn1', self.conv1(x)))
        out = F.relu(self._bn('bn2', self.conv2(out)))
        out = self._bn('bn3', self.conv3(out))
        identity = x
        if self.has_downsample:
            identity = self._bn('downsample_bn', self.downsample_conv(x))
        return F.relu(out + identity)


class ImageEmotionModel(nn.Module):
    def __init__(self, num_classes: int = 7,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 dtype: torch.dtype = torch.float32, fold_bn: bool = False,
                 quant: bool = False, quant_mode: str = 'dynamic',
                 remat: bool = False):
        super().__init__()
        if quant and not fold_bn:
            raise ValueError('quant requires fold_bn (BN-folded params)')
        self.dtype, self.fold_bn = dtype, fold_bn
        self.quant, self.quant_mode, self.remat = quant, quant_mode, remat
        self.conv1 = ConvNHWC(3, 64, 7, 2, 3, bias=fold_bn, dtype=dtype)
        if not fold_bn:
            self.bn1 = BatchNormNHWC(64, eps=BN_EPS)
        self.stages = []
        cin = 64
        for stage, n_blocks in enumerate(stage_sizes):
            f = 64 * 2 ** stage
            names = []
            for block in range(n_blocks):
                name = f'layer{stage + 1}_{block}'
                self.add_module(name, Bottleneck(
                    cin, f, stride=2 if (stage > 0 and block == 0) else 1,
                    downsample=block == 0, dtype=dtype, fold_bn=fold_bn,
                    quant=quant, quant_mode=quant_mode))
                names.append(name)
                cin = 4 * f
            self.stages.append(names)
        self.fc1 = nn.Linear(cin, 512, dtype=dtype)
        self.fc2 = nn.Linear(512, num_classes, dtype=dtype)
        self.dropout_1 = nn.Dropout(0.5)
        self.dropout_2 = nn.Dropout(0.3)
        self.eval()    # the Flax models' train=False default

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, H, W, 3) normalized NHWC -> (logits (B, 7) f32,
        head features (B, 512) f32)."""
        if self.training and self.fold_bn:
            raise ValueError('fold_bn is inference-only')
        x = self.conv1(x.to(self.dtype))
        if not self.fold_bn:
            x = self.bn1(x)
        x = F.relu(x).contiguous()
        if self.dtype == torch.bfloat16 and not self.training:
            x = pool_kernel.max_pool_3x3s2(x)
        else:
            x = pool_kernel.max_pool_3x3s2_plain(x)
        for stage, names in enumerate(self.stages):
            blocks = [getattr(self, n) for n in names]
            if (stage == 0 and self.quant and self.quant_mode == 'static'
                    and self.dtype == torch.bfloat16):
                x = resnet_kernel.layer1(x, blocks)
                continue
            for blk in blocks:
                x = remat(blk, x) if self.remat and self.training else blk(x)
        x = x.float().mean(dim=(1, 2)).to(self.dtype)
        x = self.dropout_1(x)
        feat = F.relu(F.linear(x, self.fc1.weight) + self.fc1.bias)
        logits = (F.linear(self.dropout_2(feat), self.fc2.weight)
                  + self.fc2.bias)
        return logits.float(), feat.float()
