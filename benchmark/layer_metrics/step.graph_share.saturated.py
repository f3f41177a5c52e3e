"""Share of the window's model steps that replayed a CUDA graph, in %:
100 x the count of the program's span step.replay over that of
step.launch (engine._run: the step's launches, which hold the replay
where there is one), from the StageTimer, reset when the window opens.
Both counts keep up to 4,096 spans a name, more than a window holds. 0
where every step ran eagerly; None where the program has no step.launch
span."""


def read(ctx):
    launch = ctx.timer.get('step.launch')
    if not launch:
        return None
    replay = ctx.timer.get('step.replay')
    return 100.0 * (replay['count'] if replay else 0) / launch['count']
