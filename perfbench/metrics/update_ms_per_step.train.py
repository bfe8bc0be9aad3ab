"""Busy device milliseconds a step of the ``owl.train.update`` spans the
program recorded in the traced steps: the ms between each span's two
CUDA events less update_idle_ms_per_step.train's idle, which the events
also hold (perfbench/phases.py)."""

from perfbench.phases import UPDATE, device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx, UPDATE)
