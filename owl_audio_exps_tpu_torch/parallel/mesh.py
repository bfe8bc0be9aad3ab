"""The device mesh (counterpart of owl_audio_exps_tpu/parallel/mesh.py).

The JAX package names five axes, ``data``, ``fsdp``, ``tensor``, ``seq``
and ``pipe``; the port runs the first four:

* ``data``: each data rank its own batch, gradients averaged;
* ``fsdp``: parameters, gradients, EMA and optimizer moments sharded by
  the rules of parallel/sharding.py, each weight gathered where it is
  used; the fsdp ranks also draw distinct batches, so the batch is split
  over data x fsdp (the ``batch`` ranks), as JAX's ``batch_sharding``;
* ``tensor``: megatron-style tensor parallelism over heads and the MLP
  hidden (column-parallel ``qkv`` / ``fc1``, row-parallel ``out`` /
  ``fc2``, nn/layers.py);
* ``seq``: context parallelism, each seq rank one contiguous slice of
  the frames (parallel/context.py).

``pipe`` above 1 raises (ROADMAP.md Queue 1). As in the JAX package,
``data: -1`` takes every process the other axes leave.

Ranks follow JAX's device order, ``reshape(data, fsdp, tensor, seq,
pipe)``: rank = ((d * fsdp + f) * tensor + t) * seq + s. A seq group is
therefore a run of consecutive ranks, and with fsdp = tensor = 1 the
layout is the data-major one of the data x seq mesh. ``make_mesh``
installs the mesh for the process (``get_mesh`` reads it, as the JAX
package's model code reads its global mesh); without a process group
the mesh is one rank.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence

from .dist import process_count, process_index

AXES = ("data", "fsdp", "tensor", "seq", "pipe")
# the axes the port runs, in JAX's device order
MESH_AXES = ("data", "fsdp", "tensor", "seq")


@dataclasses.dataclass
class MeshConfig:
    data: int = -1     # -1: every process the other axes leave
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1       # context parallelism (parallel/context.py)
    pipe: int = 1

    @classmethod
    def from_dict(cls, d) -> "MeshConfig":
        d = dict(d.items()) if d else {}
        unknown = set(d) - set(AXES)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}")
        return cls(**d)


@dataclasses.dataclass
class Mesh:
    """This process's place on the data x fsdp x tensor x seq mesh: the
    axis sizes, its index on each, and the process groups of the axes it
    communicates over (None on one process)."""
    data: int = 1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    data_index: int = 0
    fsdp_index: int = 0
    tensor_index: int = 0
    seq_index: int = 0
    seq_ranks: List[int] = dataclasses.field(default_factory=lambda: [0])
    seq_group: Optional[object] = None      # ProcessGroup of the seq axis
    fsdp_group: Optional[object] = None
    tensor_group: Optional[object] = None
    # every rank of this tensor index (data x fsdp x seq: the batch ranks
    # and the seq ranks that split each batch's frames): the ranks whose
    # gradients of a tensor-replicated parameter and whose metrics are
    # summed
    replica_group: Optional[object] = None
    # data x seq at this fsdp and tensor index: the ranks whose shards of
    # an fsdp-sharded parameter are summed after the reduce-scatter
    shard_replica_group: Optional[object] = None

    @property
    def batch_rank(self) -> int:
        """This process's data shard: its index over data x fsdp."""
        return self.data_index * self.fsdp + self.fsdp_index

    @property
    def batch_ranks(self) -> int:
        """The number of data shards (data x fsdp)."""
        return self.data * self.fsdp

    def size(self, axis: Optional[str]) -> int:
        return 1 if axis is None else getattr(self, axis)

    def group(self, axis: str):
        return getattr(self, f"{axis}_group")

    def seq_frames(self, n_frames: int):
        """[start, stop) of the frames this rank holds."""
        if n_frames % self.seq:
            raise ValueError(f"{n_frames} frames do not split over "
                             f"{self.seq} seq ranks")
        per = n_frames // self.seq
        return self.seq_index * per, (self.seq_index + 1) * per


_MESH: Optional[Mesh] = None


def mesh_rank(shape: Dict[str, int], coords: Dict[str, int]) -> int:
    """The rank at ``coords`` on a mesh of ``shape`` (JAX's device order)."""
    r = 0
    for axis in MESH_AXES:
        r = r * shape[axis] + coords[axis]
    return r


def mesh_coords(shape: Dict[str, int], rank: int) -> Dict[str, int]:
    out = {}
    for axis in reversed(MESH_AXES):
        out[axis] = rank % shape[axis]
        rank //= shape[axis]
    return out


def axis_groups(shape: Dict[str, int], axes: Sequence[str]) -> List[List[int]]:
    """The rank lists of every group spanning ``axes`` (the other axes
    fixed), in a fixed order."""
    rest = [a for a in MESH_AXES if a not in axes]
    groups = []
    for fixed in itertools.product(*(range(shape[a]) for a in rest)):
        coords = dict(zip(rest, fixed))
        ranks = []
        for free in itertools.product(*(range(shape[a]) for a in axes)):
            coords.update(zip(axes, free))
            ranks.append(mesh_rank(shape, coords))
        groups.append(sorted(ranks))
    return groups


def _my_group(shape, axes, rank):
    """Create every group spanning ``axes`` (each process must create
    every group, in the same order) and return the one holding
    ``rank``, or None where the axes hold one rank."""
    import torch.distributed as dist
    if all(shape[a] == 1 for a in axes):
        return None
    mine = None
    for ranks in axis_groups(shape, axes):
        g = dist.new_group(ranks)
        if rank in ranks:
            mine = g
    return mine


def make_mesh(mesh_cfg: Optional[MeshConfig] = None,
              device_type: str = "cuda") -> Mesh:
    """Build (and install) the mesh over the process group."""
    global _MESH
    mesh_cfg = mesh_cfg or MeshConfig()
    if mesh_cfg.pipe != 1:
        raise NotImplementedError(
            f"mesh axis pipe = {mesh_cfg.pipe}: the port runs data, fsdp, "
            "tensor and seq parallelism; pipe comes with a later slice "
            "(ROADMAP.md Queue 1)")
    n = process_count()
    per = mesh_cfg.fsdp * mesh_cfg.tensor * mesh_cfg.seq
    data = mesh_cfg.data if mesh_cfg.data > 0 else n // max(per, 1)
    if min(mesh_cfg.fsdp, mesh_cfg.tensor, mesh_cfg.seq) < 1 \
            or data * per != n:
        raise ValueError(
            f"mesh data {data} x fsdp {mesh_cfg.fsdp} x tensor "
            f"{mesh_cfg.tensor} x seq {mesh_cfg.seq} != {n} processes")
    if n == 1:
        _MESH = Mesh()
        return _MESH
    shape = dict(data=data, fsdp=mesh_cfg.fsdp, tensor=mesh_cfg.tensor,
                 seq=mesh_cfg.seq)
    rank = process_index()
    c = mesh_coords(shape, rank)
    seq_ranks = [mesh_rank(shape, dict(c, seq=j)) for j in range(shape["seq"])]
    groups = {name: _my_group(shape, axes, rank) for name, axes in (
        ("seq", ("seq",)), ("fsdp", ("fsdp",)), ("tensor", ("tensor",)),
        ("replica", ("data", "fsdp", "seq")),
        ("shard_replica", ("data", "seq")))}
    _MESH = Mesh(**shape, data_index=c["data"], fsdp_index=c["fsdp"],
                 tensor_index=c["tensor"], seq_index=c["seq"],
                 seq_ranks=seq_ranks,
                 **{f"{k}_group": g for k, g in groups.items()})
    return _MESH


def get_mesh() -> Mesh:
    """The installed mesh, or one rank when none was made."""
    return _MESH if _MESH is not None else Mesh()


def seq_parallel_active(config) -> bool:
    """Whether an uncached forward of ``config`` runs context-parallel:
    ``sequence_parallel`` set and the seq axis wider than one rank."""
    return bool(config.get("sequence_parallel")) and get_mesh().seq > 1
