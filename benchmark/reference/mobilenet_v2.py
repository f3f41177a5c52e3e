"""MobileNetV2 (width 1.0, torchvision's graph) with the reference's
head: conv 3x3/2 (32) -> BN -> ReLU6 -> 17 inverted residuals (expand
1x1 -> BN -> ReLU6 -> depthwise 3x3 -> BN -> ReLU6 -> project 1x1 -> BN,
plus the input where the stride is 1 and the widths match) -> conv 1x1
(1280) -> BN -> ReLU6 -> global mean -> Dense(512) -> ReLU -> Dense(7).
Returns (probs, the 512-dim head feature).

Stages: the expand and project convs and conv_head 'image_int8' (the
program runs them in int8); the stem, the depthwise convs and the head
'image_bf16'."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.resnet50 import bn, head

CFG = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
       (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


def forward(tree, x: torch.Tensor, prec):
    p, s = tree['params'], tree['batch_stats']

    def cbr(pp, ss, name, xx, stride, pad, groups, stage, act=True):
        y = bn(prec.conv(xx, pp[name]['kernel'], stride, pad, groups, stage),
               pp[name.replace('conv', 'bn')], ss[name.replace('conv', 'bn')])
        return F.relu6(y) if act else y

    x = cbr(p, s, 'conv_stem', x, 2, 1, 1, 'image_bf16')
    idx, cin = 1, 32
    for t, c, n, st in CFG:
        for i in range(n):
            bp, bs = p[f'block_{idx}'], s[f'block_{idx}']
            stride = st if i == 0 else 1
            out = x
            if t != 1:
                out = cbr(bp, bs, 'expand_conv', out, 1, 0, 1, 'image_int8')
            out = cbr(bp, bs, 'dw_conv', out, stride, 1, out.shape[1],
                      'image_bf16')
            out = cbr(bp, bs, 'project_conv', out, 1, 0, 1, 'image_int8',
                      act=False)
            x = out + x if (stride == 1 and cin == c) else out
            cin = c
            idx += 1
    x = cbr(p, s, 'conv_head', x, 1, 0, 1, 'image_int8')
    return head(p, x, prec)
