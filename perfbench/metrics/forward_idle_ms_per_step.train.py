"""Idle device milliseconds a step in the traced steps, in gaps whose
middle falls inside an ``owl.train.forward`` host range of the trace
(perfbench/phases.py)."""

from perfbench.phases import FORWARD, idle_ms_per_step


def read(ctx):
    return idle_ms_per_step(ctx, FORWARD)
