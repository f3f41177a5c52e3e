"""Median over the window's dispatches of the routed experts given at
least one real token, averaged over the text leg's expert layers: the
program's record text.moe.experts_touched (counted on the device in the
step, StageTimer reset when the window opens). None where the program
records none."""


def read(ctx):
    s = ctx.timer.get('text.moe.experts_touched')
    return s['p50_ms'] if s else None
