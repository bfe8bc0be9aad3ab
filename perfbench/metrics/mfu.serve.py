"""The window's model FLOPs (perfbench/flops.py ``serve_tick_flops``: the
pending frame's and the new frame's forwards, attention over the valid
ring slots) over the window's seconds and the card's 989 TFLOP/s;
in %."""

from perfbench.flops import PEAK_FLOPS


def read(ctx):
    w = ctx.window
    return 100.0 * w["flops"] / w["seconds"] / PEAK_FLOPS
