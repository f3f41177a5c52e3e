"""ResNet50 v1 with the reference's 2048-512-7 head, the port's
`image_variables` tree (Flax layout, HWIO kernels), drawn from the run's
trees.Draws."""

from __future__ import annotations

from typing import Dict, Sequence

from benchmark.weights.trees import Draws, bn, center_head, conv, head

TINY = {'img_size': 32}


def plan(d: Draws, stage_sizes: Sequence[int] = (3, 4, 6, 3),
         n_classes: int = 7, **_ignored) -> Dict:
    """He-normal HWIO kernels, BN as trees.bn with the residual branches'
    last BN at [0.2, 0.5]; head 2048 -> 512 -> 7 with fc2 at 16x lecun
    scale."""
    params, stats = {}, {}
    params['conv1'] = conv(d, 7, 7, 3, 64)
    params['bn1'], stats['bn1'] = bn(d, 64)
    cin = 64
    for stage, n_blocks in enumerate(stage_sizes):
        f = 64 * 2 ** stage
        for block in range(n_blocks):
            p, s = {}, {}
            p['conv1'] = conv(d, 1, 1, cin, f)
            p['bn1'], s['bn1'] = bn(d, f)
            p['conv2'] = conv(d, 3, 3, f, f)
            p['bn2'], s['bn2'] = bn(d, f)
            p['conv3'] = conv(d, 1, 1, f, 4 * f)
            p['bn3'], s['bn3'] = bn(d, 4 * f, 0.2, 0.5)
            if block == 0:
                p['downsample_conv'] = conv(d, 1, 1, cin, 4 * f)
                p['downsample_bn'], s['downsample_bn'] = bn(d, 4 * f,
                                                            0.2, 0.5)
            params[f'layer{stage + 1}_{block}'] = p
            stats[f'layer{stage + 1}_{block}'] = s
            cin = 4 * f
    params.update(head(d, cin, n_classes, 16.0))
    return {'params': params, 'batch_stats': stats}


post = center_head
