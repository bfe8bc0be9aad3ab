"""Busy device milliseconds a traced step of the MMDiT's interleave and
split: the program's ``owl.mmdit.joint`` spans (the two streams' qkv
outputs to attention's q, k and v: the per-frame ``cat``, the QK norm,
RoPE, the cast) and ``owl.mmdit.split`` spans (attention's output to the
two out-projections' inputs), each the ms between its two CUDA events
(perfbench/phases.py). They cover the forward and remat's recompute in
the backward; the backward of these operations runs inside autograd,
with no span. None where the records are not one of each per MMDiT
block forward (the program's ``block_forwards`` over the traced steps)
or any record was dropped."""

from perfbench.drivers.train_mmdit import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, {"owl.mmdit.joint": 1,
                                  "owl.mmdit.split": 1})
