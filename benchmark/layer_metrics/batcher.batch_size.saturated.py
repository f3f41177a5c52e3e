"""Mean requests a dispatch: the multimodal queue's items_run over
batches_run, as EngineBatcher.stats() moved across the window."""


def read(ctx):
    b, n = ctx.stats['batches'], ctx.stats['items']
    return n / b if b else None
