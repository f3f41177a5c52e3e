"""The grouped expert GEMM's device time over the union of the card's busy
time in the profiled sub-window, in percent: how much of the step's
device work the expert layers' kernel does. None where no launch of it
ran."""


def read(ctx):
    t, mod = ctx.trace, ctx.bounds.get('grouped_expert_gemm')
    if t is None or mod is None or not t.busy_s:
        return None
    device_s = sum(la.dur for la in t.launches
                   if any(g in la.name for g in mod.GLOBALS)) / 1e6
    return 100.0 * device_s / t.busy_s if device_s else None
