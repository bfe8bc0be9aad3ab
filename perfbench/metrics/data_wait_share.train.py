"""Share of the window's host time spent waiting for the next batch (the
trainer's ``data_stream`` through ``data/prefetch.py``), timed around
the iterator's ``next``; in %."""


def read(ctx):
    w = ctx.window
    return 100.0 * w["wait_s"] / w["seconds"]
