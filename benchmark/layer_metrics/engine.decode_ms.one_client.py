"""Median host time of predecode_multimodal (WAV decode and pad or crop,
JPEG decode and resize) in the request's thread: the harness's span
around it, over the window."""

import statistics


def read(ctx):
    d = [s[3] - s[2] for s in ctx.spans.within('decode', *ctx.window)]
    return statistics.median(d) * 1e3 if d else None
