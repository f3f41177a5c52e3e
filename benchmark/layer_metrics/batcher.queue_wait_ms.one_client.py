"""Median queue wait of a tri-modal request in the batcher (submit to
batch start): the StageTimer 'batcher.multimodal.queue_wait_ms', reset
when the window opens. The timer keeps the last 4,096 samples of a name;
a one-client window holds a few hundred, so this is all of them."""


def read(ctx):
    s = ctx.timer.get('batcher.multimodal.queue_wait_ms')
    return s['p50_ms'] if s else None
