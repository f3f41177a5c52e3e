"""Random-forest inference as one level-synchronous walk: the port of
mec_tpu/models/forest.py::forest_apply.

Every (sample, tree) pair advances one level per step, so a forest of
depth D is D rounds of dense (B, T) gathers and selects on the device,
with no data-dependent control flow. The JAX package lowers this walk
with XLA, not Pallas, so plain torch ops are its port.

Array layout (T trees padded to N nodes; node 0 is each tree's root),
the JAX package's, with int64 indices for torch's gathers
(convert/from_jax.forest_from_jax):

  feature   (T, N) int64    split feature (0 at leaves and padding)
  threshold (T, N) float32  go left iff x[feature] <= threshold
  left      (T, N) int64    left child; leaves self-loop
  right     (T, N) int64    right child; leaves self-loop
  proba     (T, N, C) float32 class distribution at every node

Leaves self-loop, so after `depth` rounds (the deepest tree's depth)
every walk has parked at its leaf. The comparison is made in fp32: the
thresholds define the walk exactly.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch


def forest_leaves(arrays: Dict[str, torch.Tensor], x: torch.Tensor,
                  depth: int) -> torch.Tensor:
    """(B, F) features -> (B, T) int64: the node each tree's walk parks
    at (sklearn's RandomForestClassifier.apply)."""
    feature, threshold = arrays['feature'], arrays['threshold']
    n_trees, n_nodes = feature.shape
    x = x.to(torch.float32)
    # flat node ids: tree t's node i is t * N + i
    base = torch.arange(n_trees, device=x.device) * n_nodes
    flat = base.expand(x.shape[0], n_trees)
    tables = [t.reshape(-1) for t in (feature, threshold, arrays['left'],
                                      arrays['right'])]
    feat_t, thr_t, left_t, right_t = tables
    for _ in range(int(depth)):
        xf = torch.gather(x, 1, feat_t[flat])
        child = torch.where(xf <= thr_t[flat], left_t[flat], right_t[flat])
        flat = base + child
    return flat - base


def forest_apply(arrays: Dict[str, torch.Tensor], x: torch.Tensor,
                 depth: int) -> torch.Tensor:
    """(B, F) features -> (B, C) class probabilities, the mean over trees
    of each tree's leaf distribution (predict_proba)."""
    leaves = forest_leaves(arrays, x, depth)
    proba = arrays['proba']
    tree = torch.arange(proba.shape[0], device=x.device)
    return proba[tree, leaves].mean(dim=1)


def from_sklearn(rf) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Fitted sklearn RandomForestClassifier -> (arrays, meta).

    meta carries the static bits: 'depth' (trace constant), 'n_features',
    'n_classes', and the fitted class order ('classes').
    """
    trees = [est.tree_ for est in rf.estimators_]
    if not trees:
        raise ValueError('forest has no fitted trees')
    N = max(t.node_count for t in trees)
    T = len(trees)
    C = int(rf.n_classes_)
    feature = np.zeros((T, N), np.int32)
    threshold = np.zeros((T, N), np.float64)
    left = np.zeros((T, N), np.int32)
    right = np.zeros((T, N), np.int32)
    proba = np.zeros((T, N, C), np.float32)
    depth = 1
    for i, t in enumerate(trees):
        n = t.node_count
        is_leaf = t.children_left[:n] == -1
        feature[i, :n] = np.where(is_leaf, 0, t.feature[:n])
        threshold[i, :n] = np.where(is_leaf, 0.0, t.threshold[:n])
        # leaves (and padding, below) self-loop so deeper iterations hold
        nodes = np.arange(n)
        left[i, :n] = np.where(is_leaf, nodes, t.children_left[:n])
        right[i, :n] = np.where(is_leaf, nodes, t.children_right[:n])
        left[i, n:] = right[i, n:] = np.arange(n, N)
        counts = t.value[:n].reshape(n, C).astype(np.float64)
        # sklearn >=1.3 stores value as weighted fractions already
        # normalized per node; normalize defensively either way
        sums = counts.sum(axis=1, keepdims=True)
        proba[i, :n] = np.divide(counts, np.where(sums == 0, 1.0, sums)
                                 ).astype(np.float32)
        depth = max(depth, int(t.max_depth))
    # sklearn compares float32 inputs against float64 thresholds
    # (midpoints of adjacent float32 feature values). For float32 x,
    # `x <= t64` is equivalent to `x <= floor32(t64)` where floor32
    # rounds t64 DOWN to the nearest float32 — round-to-nearest could
    # land above t64 and flip a boundary decision the other way.
    t32 = threshold.astype(np.float32)
    above = t32.astype(np.float64) > threshold
    t32[above] = np.nextafter(t32[above], np.float32(-np.inf),
                              dtype=np.float32)
    arrays = {'feature': feature, 'threshold': t32,
              'left': left, 'right': right, 'proba': proba}
    meta = {'kind': 'random_forest', 'depth': int(depth),
            'n_features': int(rf.n_features_in_), 'n_classes': C,
            'classes': [int(c) for c in rf.classes_]}
    return arrays, meta
