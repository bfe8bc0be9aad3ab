"""Device operations (kernels, copies, sets) a tick in the traced
ticks."""


def read(ctx):
    t = ctx.traced
    if t is None or t["trace"].kernels == 0:
        return None
    return t["trace"].kernels / t["ticks"]
