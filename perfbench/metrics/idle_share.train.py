"""1 - (union of the device operations' intervals) / (traced window), in
the traced training steps; in %."""


def read(ctx):
    t = ctx.traced
    if t is None:
        return None
    tr = t["trace"]
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
