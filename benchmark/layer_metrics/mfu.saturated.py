"""The whole step's share of the card's bf16 dense peak: the model FLOPs
of the requests completed in the window (benchmark/flops/<config>.py,
BERT at each request's own token count) over the window's seconds times
989 TFLOP/s (H100 SXM data sheet), in percent."""


def read(ctx):
    if not ctx.done:
        return None
    flops = sum(ctx.flops.request_flops(ctx.tokens(r)) for r in ctx.done)
    t0, t1 = ctx.window
    return 100.0 * flops / ((t1 - t0) * ctx.peaks['bf16_tc'])
