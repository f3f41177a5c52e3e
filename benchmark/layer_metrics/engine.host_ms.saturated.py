"""Median host time of a dispatch outside its device step: the wall of
predict_multimodal_batch less the wall of the _run it calls (the decode
stage, tokenising, wire encoding, result dicts), per dispatch over the
window."""

import statistics


def read(ctx):
    steps = ctx.spans.data.get('step', [])
    out = []
    for tid, _ident, a, b, _n in ctx.spans.within('dispatch', *ctx.window):
        inner = sum(s[3] - s[2] for s in steps
                    if s[0] == tid and a <= s[2] and s[3] <= b)
        out.append((b - a) - inner)
    return statistics.median(out) * 1e3 if out else None
