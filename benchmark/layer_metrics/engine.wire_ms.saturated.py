"""Median host wall of a dispatch's wire encode: the program's own span
trimodal.wire_encode (the rows stacked, the audio wire or the host
featurizer, WordPiece with the sequence bucket and padding, the image
wire), from the StageTimer, reset when the window opens. A saturated
window holds a few hundred dispatches, under the timer's 4,096 samples
a name, so this is all of them. None where the program has no such
span."""


def read(ctx):
    s = ctx.timer.get('trimodal.wire_encode')
    return s['p50_ms'] if s else None
