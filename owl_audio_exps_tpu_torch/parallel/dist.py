"""Process-group set-up for multi-process training (counterpart of the
JAX package's ``jax.distributed`` helpers).

One process per device. Under ``torchrun`` the rank, world size and local
rank come from its environment (RANK, WORLD_SIZE, LOCAL_RANK, and
MASTER_ADDR / MASTER_PORT for the rendezvous); a caller may also give
them, with an ``init_method`` (a ``file://`` path, or
``tcp://localhost:<port>``). NCCL serves CUDA devices, gloo the CPU.
Without a process group every helper answers for one process.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def init_distributed(device_type: str = "cuda", rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     init_method: Optional[str] = None) -> int:
    """Join the process group when the world holds more than one process
    (a no-op for one). On CUDA, binds this process to its local device.
    Returns the local rank."""
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    local_rank = int(env.get("LOCAL_RANK", rank))
    if world_size <= 1 or dist.is_initialized():
        return local_rank
    if device_type == "cuda":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        init_method=init_method or "env://", rank=rank,
        world_size=world_size)
    return local_rank


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    return process_index() == 0


def barrier():
    """Wait for every process (a no-op for one)."""
    if dist.is_initialized():
        dist.barrier()


def cleanup():
    """Leave the process group (if one was joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()


@torch.no_grad()
def broadcast_from_main(module: torch.nn.Module):
    """Put every rank on rank 0's parameters and buffers, except a
    pipeline stage's blocks (each rank draws its own from the same seed;
    the others it does not hold)."""
    if process_count() <= 1:
        return
    for t in list(module.parameters()) + list(module.buffers()):
        if not (t.is_meta or hasattr(t, "pipe_stage")):
            dist.broadcast(t.data, src=0)


def exchange(sends, recvs):
    """One batch of point-to-point transfers: ``sends`` and ``recvs`` are
    [(tensor, global rank)]; the i-th tensor to or from a peer carries tag
    i. Waits for all of them."""
    ops = [dist.P2POp(dist.isend, t, peer, tag=i)
           for i, (t, peer) in enumerate(sends)]
    ops += [dist.P2POp(dist.irecv, t, peer, tag=i)
            for i, (t, peer) in enumerate(recvs)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


# ------------------------------------------------ differentiable collectives
#
# The four collectives of the fsdp and tensor axes as autograd Functions
# over a process group (None: one rank, each the identity). gloo has no
# reduce-scatter, so there it is an all-reduce and a slice.


def _is_nccl(group) -> bool:
    return dist.get_backend(group) == "nccl"


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in group-rank order
    (not differentiable)."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    if _is_nccl(group) and dim == 0:
        out = torch.empty((n * x.shape[0],) + x.shape[1:], dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
        return out
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the group of ``x``, of which each rank keeps its
    chunk along ``dim`` (not differentiable)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if _is_nccl(group):
        x = x.movedim(dim, 0).contiguous()
        out = torch.empty((x.shape[0] // n,) + x.shape[1:], dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, x, group=group)
        return out.movedim(0, dim)
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x.chunk(n, dim=dim)[r].contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, dtype):
        ctx.dim, ctx.group, ctx.dtype = dim, group, x.dtype
        return gather_dim(x.to(dtype or x.dtype), dim, group)

    @staticmethod
    def backward(ctx, g):
        return (scatter_dim(g.to(ctx.dtype), ctx.dim, ctx.group), None,
                None, None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return scatter_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, ctx.dim, ctx.group), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_gather(x: torch.Tensor, dim: int, group,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Concatenate the group's ``x`` (cast to ``dtype`` first, when given)
    along ``dim``; the backward reduce-scatters in ``x``'s dtype, so each
    rank gets the sum of its chunk's gradients (an fsdp weight: float32
    master shards gathered in the compute dtype, their gradients summed
    in float32)."""
    if group is None:
        return x if dtype is None else x.to(dtype)
    return _AllGather.apply(x, dim, group, dtype)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Sum ``x`` over the group and keep this rank's chunk along ``dim``;
    the backward all-gathers."""
    return x if group is None else _ReduceScatter.apply(x, dim, group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over the group; the backward is the identity (the row-
    parallel output: every rank goes on with the same sum)."""
    return x if group is None else _AllReduce.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """The identity, whose backward sums the gradient over the group (the
    replicated input of a column-parallel layer)."""
    return x if group is None else _CopyToGroup.apply(x, group)


# ------------------------------------------------- the pipe axis's transfers
#
# A pipeline stage hands its activation to the next stage and takes the
# previous stage's: the transfer of the JAX package's per-tick
# ``ppermute`` (parallel/pipeline.py), whose transpose, the reverse
# transfer, carries the backward. Each is one ``batch_isend_irecv``.


class _SendNext(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, peer):
        ctx.peer, ctx.shape, ctx.dtype = peer, h.shape, h.dtype
        ctx.device = h.device
        exchange([(h.contiguous(), peer)], [])
        return h.new_empty(0)

    @staticmethod
    def backward(ctx, _):
        g = torch.empty(ctx.shape, dtype=ctx.dtype, device=ctx.device)
        exchange([], [(g, ctx.peer)])
        return g, None


class _RecvPrev(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchor, peer, shape, dtype):
        ctx.peer = peer
        h = torch.empty(shape, dtype=dtype, device=anchor.device)
        exchange([], [(h, peer)])
        return h

    @staticmethod
    def backward(ctx, g):
        exchange([(g.contiguous(), ctx.peer)], [])
        return None, None, None, None


def send_to_next(h: torch.Tensor, peer: int) -> torch.Tensor:
    """Send ``h`` to the global rank ``peer`` (the next stage); returns an
    empty token whose backward receives ``h``'s gradient from ``peer``.
    The token must reach the loss (``pipe_broadcast`` takes it)."""
    return _SendNext.apply(h, peer)


def recv_from_prev(anchor: torch.Tensor, peer: int, shape, dtype
                   ) -> torch.Tensor:
    """The activation of ``shape`` and ``dtype`` that the global rank
    ``peer`` (the previous stage) sends; the backward sends its gradient
    back. ``anchor`` is an empty tensor on the device that requires grad
    when autograd records, so that the backward runs."""
    return _RecvPrev.apply(anchor, peer, tuple(shape), dtype)


class _PipeBroadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, src, group, last, *tokens):
        ctx.last, ctx.n_tokens = last, len(tokens)
        ctx.token_meta = [(t.dtype, t.device) for t in tokens]
        y = y.contiguous().clone() if last else torch.empty_like(y)
        dist.broadcast(y, src=src, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        tokens = [torch.zeros(0, dtype=d, device=dev)
                  for d, dev in ctx.token_meta]
        return (g if ctx.last else None, None, None, None, *tokens)


def pipe_broadcast(y: torch.Tensor, src: int, group, last: bool, tokens
                   ) -> torch.Tensor:
    """The last stage's ``y`` on every rank of the pipe ``group`` (``src``
    its global rank; elsewhere ``y`` gives the shape and dtype only): the
    JAX package's psum of the output, zero on every stage but the last.
    Every pipe rank then computes the same loss from it, so the transpose
    hands the last stage the output's gradient once; the ``tokens`` of
    this rank's sends take none, which runs their backward (the stage's
    own)."""
    return _PipeBroadcast.apply(y, src, group, last, *tokens)
