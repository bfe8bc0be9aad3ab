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
