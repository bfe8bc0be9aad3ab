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
    """Put every rank on rank 0's parameters and buffers."""
    if process_count() <= 1:
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0)


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
