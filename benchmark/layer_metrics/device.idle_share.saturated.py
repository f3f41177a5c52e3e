"""The share of the profiled sub-window in which no kernel, copy or set
ran on the card, in percent."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t else None
