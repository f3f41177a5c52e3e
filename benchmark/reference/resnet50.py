"""ResNet50 v1 (torchvision's graph: stride on the 3x3 conv) with the
reference's head: conv 7x7/2 -> BN (eps 1e-5) -> ReLU -> max pool 3x3/2
-> [3, 4, 6, 3] bottlenecks -> global mean -> Dense(512) -> ReLU ->
Dense(7). Returns (probs, the 512-dim head feature).

Stages: the bottleneck convs (and downsample convs) 'image_int8' (the
program runs them in int8), the stem conv and the head 'image_bf16'."""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-5


def bn(x, p, s):
    shape = (1, -1, 1, 1)
    return ((x - s['mean'].view(shape)) / torch.sqrt(s['var'].view(shape)
                                                     + EPS)
            * p['scale'].view(shape) + p['bias'].view(shape))


def head(p, x, prec):
    x = x.mean(dim=(2, 3))
    feat = torch.relu(prec.linear(x, p['fc1']['kernel'], p['fc1']['bias'],
                                  'image_bf16'))
    logits = prec.linear(feat, p['fc2']['kernel'], p['fc2']['bias'],
                         'image_bf16')
    return torch.softmax(logits, -1), feat


def forward(tree, x: torch.Tensor, prec):
    """x: (B, 3, H, W) normalised."""
    p, s = tree['params'], tree['batch_stats']
    x = torch.relu(bn(prec.conv(x, p['conv1']['kernel'], 2, 3, 1,
                                'image_bf16'), p['bn1'], s['bn1']))
    x = F.max_pool2d(x, 3, 2, 1)
    for stage in range(1, 5):
        b = 0
        while f'layer{stage}_{b}' in p:
            bp, bs = p[f'layer{stage}_{b}'], s[f'layer{stage}_{b}']
            stride = 2 if (stage > 1 and b == 0) else 1

            def conv(name, xx, st, pad):
                return bn(prec.conv(xx, bp[name]['kernel'], st, pad, 1,
                                    'image_int8'),
                          bp[name.replace('conv', 'bn')],
                          bs[name.replace('conv', 'bn')])

            out = torch.relu(conv('conv1', x, 1, 0))
            out = torch.relu(conv('conv2', out, stride, 1))
            out = conv('conv3', out, 1, 0)
            idt = (conv('downsample_conv', x, stride, 0)
                   if 'downsample_conv' in bp else x)
            x = torch.relu(out + idt)
            b += 1
    return head(p, x, prec)
