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

from typing import Dict

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
