"""The grouped expert GEMM's share of its roofline in the profiled
sub-window, in percent: the sum, over the steps that start inside it, of
its bound (benchmark/bounds/grouped_expert_gemm.py at the step's bucket
and the window's mean routing counts, text.moe.experts_touched and
text.moe.routed_pairs), over the device time of its launches there.
None where no launch of it ran (a program without the kernel) or the
program records no routing."""


def read(ctx):
    t, mod = ctx.trace, ctx.bounds.get('grouped_expert_gemm')
    if t is None or mod is None:
        return None
    device_ms = sum(la.dur for la in t.launches
                    if any(g in la.name for g in mod.GLOBALS)) / 1e3
    steps = [s[4] for s in ctx.spans.within('step', t.start, t.stop)]
    touched = ctx.timer.get('text.moe.experts_touched')
    pairs = ctx.timer.get('text.moe.routed_pairs')
    if not device_ms or not steps or not touched or not pairs:
        return None
    bound = sum(mod.bound_ms(n, experts_touched=touched['mean_ms'],
                             routed_pairs=pairs['mean_ms']) for n in steps)
    return 100.0 * bound / device_ms
