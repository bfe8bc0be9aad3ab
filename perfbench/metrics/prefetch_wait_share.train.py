"""Share of the traced window the trainer's loop spent blocked on the
next batch inside data/prefetch.py: the host seconds of the program's
``owl.data.wait`` spans over the window; in % (perfbench/phases.py)."""

from perfbench.phases import wait_share


def read(ctx):
    return wait_share(ctx)
