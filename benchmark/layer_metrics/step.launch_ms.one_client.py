"""Median host wall of the tri-modal step's launches: the program's own
span step.launch (engine._run around the step method, after the copies
in and before the rows come back), from the StageTimer, reset when the
window opens. A one-client window holds a few hundred dispatches, under
the timer's 4,096 samples a name, so this is all of them. None where the
program has no such span."""


def read(ctx):
    s = ctx.timer.get('step.launch')
    return s['p50_ms'] if s else None
