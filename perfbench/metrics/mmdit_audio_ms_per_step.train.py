"""Busy device milliseconds a traced step of the MMDiT's audio stream:
the program's ``owl.mmdit.audio`` spans around the stream's own work in
each block (its qkv projection, its out projection, its MLP sub-layer),
GEMMs of one row a frame beside the video stream's 64, each span the ms
between its two CUDA events (perfbench/phases.py). They cover the
forward and remat's recompute in the backward; the backward of this
work runs inside autograd, with no span. None where the records are not
three per MMDiT block forward (the program's ``block_forwards`` over the
traced steps) or any record was dropped."""

from perfbench.drivers.train_mmdit import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, {"owl.mmdit.audio": 3})
