"""Weights drawn one leaf at a time on the run's device, for legs too large
for trees.Draws (which draws every leaf of a configuration in one buffer
and scales it on the host).

A Leaf is a recipe: its shape and its init (normal with a std, uniform in
[lo, hi), or a constant). make_trees calls bind(trees, seed, device),
which names each leaf by its path in the trees ('text/params/layer_3/
mlp/kernel') and gives it the run's seed and device. Calling a bound leaf
draws it alone, from a torch.Generator on that device seeded by (run
seed, path), in float32, and casts it to the dtype asked for: the same
numbers in any order and on every call, and nothing of it on the host.
materialize(tree, dtype) draws every leaf of a (sub)tree and leaves
everything else as it is, so a reference piece can draw one layer, apply
it and drop it.
"""

from __future__ import annotations

import hashlib
from typing import Any

import torch


def leaf_seed(seed: int, path: str) -> int:
    """A 63-bit generator seed from the run's seed and a leaf's path."""
    h = hashlib.sha256(f'{int(seed)}/{path}'.encode()).digest()
    return int.from_bytes(h[:8], 'little') >> 1


class Leaf:
    __slots__ = ('init', 'shape', 'a', 'b', 'path', 'seed', 'device')

    def __init__(self, init: str, shape, a: float, b: float = 0.0):
        self.init, self.shape, self.a, self.b = init, tuple(shape), a, b
        self.path = self.seed = self.device = None

    def __call__(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        if self.path is None:
            raise RuntimeError('a seeded leaf is drawn only after bind()')
        if self.init == 'full':
            x = torch.full(self.shape, self.a, device=self.device)
            return x if dtype == torch.float32 else x.to(dtype)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(leaf_seed(self.seed, self.path))
        if self.init == 'normal':
            x = torch.randn(self.shape, generator=gen, device=self.device)
            x.mul_(self.a)
        else:
            x = torch.rand(self.shape, generator=gen, device=self.device)
            x.mul_(self.b - self.a).add_(self.a)
        return x if dtype == torch.float32 else x.to(dtype)


def normal(*shape, std: float) -> Leaf:
    return Leaf('normal', shape, float(std))


def uniform(lo: float, hi: float, *shape) -> Leaf:
    return Leaf('uniform', shape, float(lo), float(hi))


def full(value: float, *shape) -> Leaf:
    return Leaf('full', shape, float(value))


def bind(tree: Any, seed: int, device, path: str = '') -> Any:
    """Name every Leaf in `tree` by its path and give it the seed and the
    device, in place; returns the tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            bind(v, seed, device, f'{path}/{k}' if path else str(k))
    elif isinstance(tree, Leaf):
        tree.path, tree.seed, tree.device = path, int(seed), device
    return tree


def materialize(tree: Any, dtype: torch.dtype = torch.float32) -> Any:
    """The tree with every Leaf drawn in `dtype`; other values as they
    are."""
    if isinstance(tree, dict):
        return {k: materialize(v, dtype) for k, v in tree.items()}
    if isinstance(tree, Leaf):
        return tree(dtype)
    return tree
