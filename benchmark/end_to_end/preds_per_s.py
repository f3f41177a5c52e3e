"""Tri-modal requests answered inside the window, per second of it."""

from benchmark.harness.stats import rate


def read(ctx):
    return rate([r.t_done for r in ctx.records if ctx.ok(r)], *ctx.window)
