"""The hand-written kernels' share of their roofline in the profiled
sub-window, in percent: the sum, over the steps that start inside it, of
the bound of each kernel that ran there (benchmark/bounds/<kernel>.py at
the step's bucket), over the device time of every launch of those
kernels in it. A step's launches at the sub-window's edges fall on one
side or the other; over the tens of steps of a sub-window they even out."""


def read(ctx):
    if ctx.trace is None:
        return None
    steps = [s[4] for s in ctx.spans.within('step', ctx.trace.start,
                                            ctx.trace.stop)]
    device, ran = 0.0, {}
    for launch in ctx.trace.launches:
        mod = ctx.kernel_of(launch.name)
        if mod is not None:
            device += launch.dur / 1e3
            ran[mod.__name__] = mod
    bound = sum(mod.bound_ms(n) for mod in ran.values() for n in steps)
    return 100.0 * bound / device if device and steps else None
