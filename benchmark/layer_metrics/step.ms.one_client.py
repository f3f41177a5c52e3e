"""Median host wall of the model step: engine._run('_trimodal_forward')
(copies in, the step's launches, the packed rows back to the host), per
dispatch over the window."""

import statistics


def read(ctx):
    d = [s[3] - s[2] for s in ctx.spans.within('step', *ctx.window)]
    return statistics.median(d) * 1e3 if d else None
