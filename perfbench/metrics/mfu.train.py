"""The window's model FLOPs (perfbench/flops.py: matmuls plus attention
over each batch's visible pairs, three forwards a step) over the
window's seconds and the card's 989 TFLOP/s; in %."""

from perfbench.flops import PEAK_FLOPS


def read(ctx):
    w = ctx.window
    return 100.0 * w["flops"] / w["seconds"] / PEAK_FLOPS
