"""Random-init speech parameters for smoke runs, benchmarks and tests.

The port's counterpart of mec_tpu/serving/synthetic_artifacts.py, for the
speech slice: the reference ships no weights, so the serving graph runs
on random ones, made with numpy from a seed (jax.random keys and torch
generators give different numbers from one seed; numpy feeds both
packages the same). The tree has the Flax layout the JAX package uses,
which is what the port's engine takes.
"""

from __future__ import annotations

from typing import Dict, Sequence

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
