"""Conv+BatchNorm folding for the serving image path.

A copy of mec_tpu/ops/fold.py (importing mec_tpu imports jax); the one
change is the batch_stats leaf count, a numpy walk here where the
original calls jax.tree_util.tree_leaves. tests/test_torch_image.py
pins the folded tree to the original's.

At inference BatchNorm is an affine per-channel transform of the conv
output:

    y = gamma * (conv(x) - mean) / sqrt(var + eps) + beta
      = conv'(x) + b'     with  K' = K * s,  b' = beta - mean * s,
                                s  = gamma / sqrt(var + eps)

so bf16 serving mode folds every (conv, bn) pair into the conv kernel
and a bias at load and serves the model with fold_bn=True; fp32 parity
mode keeps live BatchNorm.

Pairing is by the models' naming convention: a conv param named
``*conv*`` folds with the sibling whose name is ``name.replace('conv',
'bn')`` (conv1/bn1, downsample_conv/downsample_bn).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

BN_EPS = 1e-5  # both image models (torchvision BatchNorm2d default)


def _fold_node(params_node: Dict, stats_node: Dict) -> Tuple[Dict, int]:
    """Fold one module-level dict; recurses into submodules."""
    out = {}
    n_folded = 0
    bn_names = set()
    for name in params_node:
        if 'conv' in name and name.replace('conv', 'bn') in params_node:
            bn_names.add(name.replace('conv', 'bn'))
    for name, val in params_node.items():
        if name in bn_names:
            continue  # consumed by its conv
        bn_name = name.replace('conv', 'bn')
        if 'conv' in name and bn_name in bn_names:
            extra = set(val) - {'kernel', 'bias'}
            if extra:  # a key the fold would silently drop -> refuse
                raise ValueError(f'fold_conv_bn: conv {name!r} has '
                                 f'unexpected params {sorted(extra)}')
            K = np.asarray(val['kernel'], np.float32)
            bn_p, bn_s = params_node[bn_name], stats_node[bn_name]
            s = (np.asarray(bn_p['scale'], np.float32)
                 / np.sqrt(np.asarray(bn_s['var'], np.float32) + BN_EPS))
            # y = (conv(x) + b0 - mean) * s + beta: a conv's own bias
            # (use_bias convs in converted artifacts) folds as (b0-mean)*s
            b0 = (np.asarray(val['bias'], np.float32)
                  if 'bias' in val else 0.0)
            out[name] = {
                # HWIO: output channel last for both plain and depthwise
                'kernel': K * s,
                'bias': (np.asarray(bn_p['bias'], np.float32)
                         + (b0 - np.asarray(bn_s['mean'], np.float32)) * s),
            }
            n_folded += 1
        elif isinstance(val, dict) and 'kernel' not in val \
                and 'embedding' not in val:
            sub, n = _fold_node(val, stats_node.get(name, {}))
            out[name] = sub
            n_folded += n
        else:
            out[name] = val
    return out, n_folded


def _count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    return 0 if tree is None else 1


def fold_conv_bn(variables: Dict) -> Dict:
    """{'params', 'batch_stats'} -> {'params'} with every (conv, bn)
    pair folded; raises if nothing folded (wrong tree) or if any
    batch_stats entry was left unconsumed (a bn the fold missed would
    silently change the graph)."""
    params = variables['params']
    stats = variables.get('batch_stats', {})
    folded, n = _fold_node(params, stats)
    if n == 0:
        raise ValueError('fold_conv_bn: no (conv, bn) pairs found')
    n_stats = _count_leaves(stats)
    # every bn contributes mean+var
    if n_stats != 2 * n:
        raise ValueError(f'fold_conv_bn: folded {n} pairs but batch_stats '
                         f'has {n_stats} leaves (expected {2 * n})')
    return {'params': folded}
