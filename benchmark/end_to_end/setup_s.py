"""Seconds from the process's start to the window's first request:
imports, the card's context, the kernels from the build directory in the
checkout, the weights from the seed, the engine (conversion, int8
calibration), its warm-up of the cell's buckets, and the warm-up
requests. The benchmark's own inputs (the traffic's pools and texts,
the vocabulary) are drawn in set-up too, but their time is left out."""


def read(ctx):
    return ctx.setup_s
