"""Random-init speech and image parameters for smoke runs and tests.

The port's counterpart of mec_tpu/serving/synthetic_artifacts.py, for the
ported slices: the reference ships no weights, so the serving graph runs
on random ones, made with numpy from a seed (jax.random keys and torch
generators give different numbers from one seed; numpy feeds both
packages the same). The tree has the Flax layout the JAX package uses,
which is what the port's engine takes.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def speech_variables(seed: int = 0, in_dim: int = 56,
                     widths: Sequence[int] = (512, 512, 256, 128, 64),
                     n_classes: int = 7) -> Dict:
    """Full-width SpeechDNN {'params', 'batch_stats'} tree of float32
    numpy arrays: lecun-normal Dense kernels (the output layer's doubled
    so random weights still separate the classes), small biases, BN
    scale in [0.5, 1.5] and running var in [0.5, 2]."""
    rng = np.random.RandomState(seed)
    params, stats = {}, {}
    d = in_dim
    for i, w in enumerate(widths):
        params[f'dense_{i}'] = {
            'kernel': (rng.randn(d, w) / np.sqrt(d)).astype(np.float32),
            'bias': (0.05 * rng.randn(w)).astype(np.float32)}
        params[f'bn_{i}'] = {
            'scale': rng.uniform(0.5, 1.5, w).astype(np.float32),
            'bias': (0.1 * rng.randn(w)).astype(np.float32)}
        stats[f'bn_{i}'] = {
            'mean': (0.1 * rng.randn(w)).astype(np.float32),
            'var': rng.uniform(0.5, 2.0, w).astype(np.float32)}
        d = w
    params['dense_out'] = {
        'kernel': (2.0 * rng.randn(d, n_classes) / np.sqrt(d)
                   ).astype(np.float32),
        'bias': (0.05 * rng.randn(n_classes)).astype(np.float32)}
    return {'params': params, 'batch_stats': stats}


def image_variables(seed: int = 0, image_size: int = 224,
                    stage_sizes: Sequence[int] = (3, 4, 6, 3),
                    n_classes: int = 7) -> Tuple[Dict, Dict]:
    """Full-width ResNet50 {'params', 'batch_stats'} tree of float32 numpy
    arrays in the Flax layout of mec_tpu/models/resnet.py, and its meta
    ({'img_size': image_size}).

    He-normal conv kernels (HWIO) keep each conv's output at its input's
    scale; BN running var in [0.5, 2] and scale in [0.5, 1.5] keep it
    there, and the last BN of every residual branch (bn3,
    downsample_bn) scales by [0.2, 0.5] so the residual stream grows
    slowly and stays finite through all 16 blocks. BN shifts (bias,
    running mean) are small (0.02 N(0, 1)): larger constant shifts make
    every image's pooled features alike. The head is Dense
    2048->512->7. Pooled features of a random net still share a large
    positive component (and so do the post-ReLU head features), so the
    weights into each fc1 unit and each class are made zero-mean (they
    read the image-dependent part), and fc2 is at 16x lecun scale:
    random weights then separate the classes."""
    rng = np.random.RandomState(seed)

    def conv(kh, kw, cin, cout):
        std = np.sqrt(2.0 / (kh * kw * cin))
        return {'kernel': (std * rng.randn(kh, kw, cin, cout)
                           ).astype(np.float32)}

    def bn(c, lo=0.5, hi=1.5):
        p = {'scale': rng.uniform(lo, hi, c).astype(np.float32),
             'bias': (0.02 * rng.randn(c)).astype(np.float32)}
        s = {'mean': (0.02 * rng.randn(c)).astype(np.float32),
             'var': rng.uniform(0.5, 2.0, c).astype(np.float32)}
        return p, s

    params, stats = {}, {}
    params['conv1'] = conv(7, 7, 3, 64)
    params['bn1'], stats['bn1'] = bn(64)
    cin = 64
    for stage, n_blocks in enumerate(stage_sizes):
        f = 64 * 2 ** stage
        for block in range(n_blocks):
            p, s = {}, {}
            p['conv1'] = conv(1, 1, cin, f)
            p['bn1'], s['bn1'] = bn(f)
            p['conv2'] = conv(3, 3, f, f)
            p['bn2'], s['bn2'] = bn(f)
            p['conv3'] = conv(1, 1, f, 4 * f)
            p['bn3'], s['bn3'] = bn(4 * f, 0.2, 0.5)
            if block == 0:
                p['downsample_conv'] = conv(1, 1, cin, 4 * f)
                p['downsample_bn'], s['downsample_bn'] = bn(4 * f, 0.2, 0.5)
            params[f'layer{stage + 1}_{block}'] = p
            stats[f'layer{stage + 1}_{block}'] = s
            cin = 4 * f
    k1 = rng.randn(cin, 512) / np.sqrt(cin)
    params['fc1'] = {
        'kernel': (k1 - k1.mean(axis=0)).astype(np.float32),
        'bias': (0.05 * rng.randn(512)).astype(np.float32)}
    k2 = 16.0 * rng.randn(512, n_classes) / np.sqrt(512)
    params['fc2'] = {
        'kernel': (k2 - k2.mean(axis=0)).astype(np.float32),
        'bias': (0.05 * rng.randn(n_classes)).astype(np.float32)}
    return ({'params': params, 'batch_stats': stats},
            {'img_size': image_size})


def layer1_quant_params(seed: int = 0) -> Dict:
    """Static-int8 QuantConv params of ResNet50 layer1 ({'layer1_0':
    {'conv1': ..., 'downsample_conv': ...}, 'layer1_1': ..., ...}), the
    recipe of the JAX package's layer1 kernel test
    (tests/test_pallas_resnet.py::_quant_params): kernels 0.1 * N(0, 1),
    per-channel scales, biases 0.05 * N(0, 1), act scales in
    [0.01, 0.05]."""
    rng = np.random.RandomState(seed)

    def conv(cin, cout, ksize=1):
        kw = rng.randn(ksize, ksize, cin, cout).astype(np.float32) * 0.1
        ks = np.abs(kw).max(axis=(0, 1, 2)) / 127.0 + 1e-8
        return {'kernel_q': np.clip(np.round(kw / ks), -127, 127
                                    ).astype(np.int8),
                'kernel_scale': ks.astype(np.float32),
                'bias': (rng.randn(cout) * 0.05).astype(np.float32),
                'act_scale': np.float32(rng.uniform(0.01, 0.05))}

    params = {}
    for blk in range(3):
        cin = 64 if blk == 0 else 256
        p = {'conv1': conv(cin, 64), 'conv2': conv(64, 64, 3),
             'conv3': conv(64, 256)}
        if blk == 0:
            p['downsample_conv'] = conv(64, 256)
        params[f'layer1_{blk}'] = p
    return params
