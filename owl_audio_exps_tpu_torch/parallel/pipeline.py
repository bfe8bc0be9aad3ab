"""Pipeline parallelism over the ``pipe`` mesh axis (counterpart of
owl_audio_exps_tpu/parallel/pipeline.py).

The JAX package splits the ``scan_layers`` group stack (one local/global
period of ``local_idx`` blocks a group) over K stages and runs one SPMD
program of T = M + K - 1 ticks over M micro-batches: at tick t stage s
runs micro-batch t - s and hands its activation to stage s + 1 with one
``ppermute``, whose transpose carries the backward; the last stage's
output is replicated over ``pipe`` by a psum.

The port holds whole groups a stage: stage s keeps blocks [s n / K,
(s + 1) n / K) of the n blocks (``stage_blocks``; the others are not
kept, parallel/sharding.py ``shard_params``), and every rank runs the
layers outside the stack (the embeddings, ``proj_in``, ``proj_out``, the
loss) on the same data. ``pipeline_apply`` runs the GPipe order eagerly:
stage 0 takes micro-batch m of the input, every other stage receives it
from the stage before (parallel/dist.py ``recv_from_prev``), runs its
blocks and sends the result on (``send_to_next``); the last stage's
outputs are broadcast over the pipe group (``pipe_broadcast``). Each
stage waits only for its own input, so the stages overlap as the ticks
do; JAX's bubble ticks, which compute on data that is thrown away, are
not run. The backward runs the transfers in reverse, micro-batch M - 1
first on every stage.

The input activation and the per-frame ``cond`` enter the stack on every
pipe rank, and each stage's gradient of them is partial (``cond`` feeds
every stage, the input stage 0 alone): their gradients are summed over
the pipe group as they leave the stack (the transpose of their
replication over ``pipe`` in the JAX package's shard_map). Every pipe rank
then holds the whole gradient of every parameter it shares with the
others, and the blocks' gradients live on their stage, so the trainer
sums nothing over ``pipe``.

Refused, with the JAX package's words: ``seq`` > 1 (parallel/mesh.py
refuses the mesh), a group count that the stages do not divide, and a
batch that the M micro-batches do not divide; document packing is
refused by nn/attn.py's ``DiT``.
"""

from __future__ import annotations

from typing import Callable

import torch

from .dist import pipe_broadcast, recv_from_prev, send_to_next
from .mesh import Mesh, get_mesh


def pipeline_ok(mesh: Mesh) -> bool:
    """True when the mesh has an engaged pipe axis."""
    return mesh.pipe > 1


def pipeline_active(config, mesh: Mesh = None) -> bool:
    """Whether an uncached forward of ``config``'s DiT runs the pipeline:
    ``pipeline_parallel`` on a mesh with an engaged pipe axis, with
    ``scan_layers`` and ``n_layers`` a multiple of ``local_idx`` (the JAX
    package's conditions, nn/attn.py:559-567). Otherwise every pipe rank
    runs the whole stack."""
    mesh = mesh or get_mesh()
    local_idx = config.get("local_idx", 4) or 4
    return (bool(config.get("pipeline_parallel")) and pipeline_ok(mesh)
            and bool(config.get("scan_layers", False))
            and config.n_layers % local_idx == 0)


def stage_blocks(config, n_stages: int, stage: int) -> range:
    """The blocks stage ``stage`` of ``n_stages`` holds: whole groups,
    [s n / K, (s + 1) n / K). Raises where the stages do not divide the
    groups."""
    local_idx = config.get("local_idx", 4) or 4
    n_groups = config.n_layers // local_idx
    if n_groups % n_stages:
        raise ValueError(f"n_groups={n_groups} must divide over "
                         f"pipe={n_stages} stages")
    per = config.n_layers // n_stages
    return range(stage * per, (stage + 1) * per)


class _PipeEnter(torch.autograd.Function):
    """x and cond entering the stack: the identity, whose backward sums
    their gradients over the pipe group (one node, so every stage runs
    the two sums last, in the same order)."""

    @staticmethod
    def forward(ctx, group, x, cond):
        ctx.group = group
        return x.view_as(x), cond.view_as(cond)

    @staticmethod
    def backward(ctx, gx, gc):
        import torch.distributed as dist
        out = []
        for g in (gx, gc):
            g = g.contiguous().clone()
            dist.all_reduce(g, group=ctx.group)
            out.append(g)
        return (None, *out)


def pipeline_apply(mesh: Mesh, run_stage: Callable, x: torch.Tensor,
                   cond: torch.Tensor, microbatches: int) -> torch.Tensor:
    """Run this rank's stage of the stack in a K-stage GPipe schedule.

    x: [b, L, D] this batch rank's activations; cond: [b, F, D];
    run_stage(h, c) applies the stage's blocks to one micro-batch.
    Returns [b, L, D] on every pipe rank, equal to running the blocks in
    order (the same math, reassociated only by the micro-batch split)."""
    K, s = mesh.pipe, mesh.pipe_index
    M = int(microbatches)
    if mesh.seq > 1:
        raise ValueError(
            f"pipeline_parallel cannot compose with seq={mesh.seq}: "
            "context parallelism is its own manual shard_map over 'seq' "
            "(parallel/context.py) and cannot nest inside the pipeline's "
            "shard_map region")
    b = x.shape[0]
    dp = mesh.batch_ranks
    if b % M:
        raise ValueError(f"batch {b * dp} must split over data={dp} then "
                         f"into M={M} microbatches per shard")
    bm = b // M
    if torch.is_grad_enabled() and (x.requires_grad or cond.requires_grad):
        x, cond = _PipeEnter.apply(mesh.pipe_group, x, cond)
    anchor = torch.zeros(0, device=x.device,
                         requires_grad=torch.is_grad_enabled())
    tokens, outs = [], []
    for m in range(M):
        rows = slice(m * bm, (m + 1) * bm)
        if s == 0:
            h = x[rows]
        else:
            h = recv_from_prev(anchor, mesh.prev_stage_rank,
                               (bm,) + tuple(x.shape[1:]), x.dtype)
        h = run_stage(h, cond[rows])
        if s < K - 1:
            tokens.append(send_to_next(h, mesh.next_stage_rank))
        else:
            outs.append(h)
    y = torch.cat(outs) if outs else x
    return pipe_broadcast(y, mesh.pipe_ranks[K - 1], mesh.pipe_group,
                          s == K - 1, tokens)
