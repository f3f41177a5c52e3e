"""MobileNetV2 (width 1.0) with the reference's 1280-512-7 head, the
port's `image_variables` tree (Flax layout, HWIO kernels), drawn from the
run's trees.Draws."""

from __future__ import annotations

from typing import Dict

from benchmark.weights.trees import Draws, bn, center_head, conv, head

TINY = {'img_size': 32}

# torchvision mobilenet_v2 inverted-residual settings (t, c, n, s)
INVERTED_RESIDUAL_CFG = (
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


def plan(d: Draws, n_classes: int = 7, **_ignored) -> Dict:
    """He-normal kernels (a depthwise one (3, 3, 1, C) with fan-in 9),
    project_bn at [1, 2] where a stage begins and [0.3, 0.6] in a
    residual block; fc2 at 4x lecun scale."""
    params, stats = {}, {}
    params['conv_stem'] = conv(d, 3, 3, 3, 32)
    params['bn_stem'], stats['bn_stem'] = bn(d, 32)
    idx, cin = 1, 32
    for t, c, n, _s in INVERTED_RESIDUAL_CFG:
        for i in range(n):
            hidden = cin * t
            p, st = {}, {}
            if t != 1:
                p['expand_conv'] = conv(d, 1, 1, cin, hidden)
                p['expand_bn'], st['expand_bn'] = bn(d, hidden)
            p['dw_conv'] = conv(d, 3, 3, 1, hidden, fan_in=9)
            p['dw_bn'], st['dw_bn'] = bn(d, hidden)
            p['project_conv'] = conv(d, 1, 1, hidden, c)
            p['project_bn'], st['project_bn'] = bn(
                d, c, *((0.3, 0.6) if i else (1.0, 2.0)))
            params[f'block_{idx}'], stats[f'block_{idx}'] = p, st
            cin = c
            idx += 1
    params['conv_head'] = conv(d, 1, 1, cin, 1280)
    params['bn_head'], stats['bn_head'] = bn(d, 1280)
    params.update(head(d, 1280, n_classes, 4.0))
    return {'params': params, 'batch_stats': stats}


post = center_head
