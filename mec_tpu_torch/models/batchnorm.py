"""Flax's BatchNorm training step, and remat that keeps it single.

train_batch_norm is flax.linen.BatchNorm(use_running_average=False) on
channel-last activations, for the port's BatchNorm modules (torch's
BatchNorm1d/2d state: weight, bias, running_mean, running_var). It
differs from torch's own training update in two ways that change the
stored statistics:

  * the running variance takes the biased batch variance (torch's takes
    the unbiased one, n/(n-1) larger);
  * the statistics are fp32 E[x] and E[x^2] - E[x]^2 clipped at 0
    (Flax's use_fast_variance=True), whatever the activation dtype.

The update is ra = m * ra + (1 - m) * batch with Flax's momentum m,
which is 1 - torch's `momentum` attribute (speech 0.99, ResNet50 and
MobileNetV2 0.9). The output normalises with the batch statistics in
fp32 and is cast back to the input's dtype.

remat(module, *args) is flax.linen.remat: torch.utils.checkpoint
(use_reentrant=False, the RNG state preserved) re-runs the forward in
the backward pass, and the BatchNorms inside update their statistics on
the first run only, as Flax returns the mutated collection once. So
remat is bit-exact against no remat.

Inside a data-parallel fit (parallel/mesh.data_parallel) the statistics
are the global batch's: the per-rank sums of x and x^2 and the row
count are all-reduced (autograd-aware, so the backward pass sees the
global statistics too) before E[x] and E[x^2] are taken, as JAX's BN
over a batch sharded on 'data' reduces under GSPMD.

wide(x) is the statistics' dtype: fp32 for bf16 and fp32 activations
(Flax's promote_types(x.dtype, float32)), float64 for float64.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mec_tpu_torch.parallel import mesh as pmesh


def wide(x: torch.Tensor) -> torch.Tensor:
    """x in at least fp32 (float64 stays float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def train_batch_norm(bn: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Normalise channel-last x (..., C) with its batch statistics (the
    global batch's inside a data-parallel fit) and, unless
    bn.update_stats is False, fold them into bn's running ones."""
    xf = wide(x)
    dims = tuple(range(x.dim() - 1))
    dmesh = pmesh.active()
    if dmesh is None:
        mean = xf.mean(dim=dims)
        sq = (xf * xf).mean(dim=dims)
    else:
        c = xf.shape[-1]
        sums = dmesh.all_reduce_sum(torch.cat([
            xf.sum(dim=dims), (xf * xf).sum(dim=dims),
            xf.new_full((1,), float(xf.numel() // c))]))
        mean, sq = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
    var = torch.clamp(sq - mean * mean, min=0.0)
    if getattr(bn, 'update_stats', True):
        m = 1.0 - bn.momentum
        with torch.no_grad():
            bn.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
            bn.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
    y = (xf - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias
    return y.to(x.dtype)


class BatchNorm1d(nn.BatchNorm1d):
    """nn.BatchNorm1d whose training step is Flax's (train_batch_norm)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return train_batch_norm(self, x)
        return super().forward(x)


def remat(module: nn.Module, *args):
    """module(*args) under activation checkpointing, with the BatchNorm
    statistics updated on the forward run and not on the recompute."""
    norms = [m for m in module.modules() if hasattr(m, 'running_var')]
    runs = [0]

    def run(*a):
        runs[0] += 1
        first = runs[0] == 1
        for m in norms:
            m.update_stats = first
        try:
            return module(*a)
        finally:
            for m in norms:
                m.update_stats = True

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=True)
