"""The device mesh (counterpart of owl_audio_exps_tpu/parallel/mesh.py).

The JAX package names five axes, ``data``, ``fsdp``, ``tensor``, ``seq``
and ``pipe``; the port runs all five:

* ``data``: each data rank its own batch, gradients averaged;
* ``fsdp``: parameters, gradients, EMA and optimizer moments sharded by
  the rules of parallel/sharding.py, each weight gathered where it is
  used; the fsdp ranks also draw distinct batches, so the batch is split
  over data x fsdp (the ``batch`` ranks), as JAX's ``batch_sharding``;
* ``tensor``: megatron-style tensor parallelism over heads and the MLP
  hidden (column-parallel ``qkv`` / ``fc1``, row-parallel ``out`` /
  ``fc2``, nn/layers.py);
* ``seq``: context parallelism, each seq rank one contiguous slice of
  the frames (parallel/context.py);
* ``pipe``: pipeline parallelism, each pipe rank one stage of the DiT's
  blocks in a GPipe schedule (parallel/pipeline.py); the pipe ranks of
  one batch rank take the same batch. ``pipe`` and ``seq`` do not
  compose, as in the JAX package.

As in the JAX package, ``data: -1`` takes every process the other axes
leave.

Ranks follow JAX's device order, ``reshape(data, fsdp, tensor, seq,
pipe)``: rank = (((d * fsdp + f) * tensor + t) * seq + s) * pipe + p. The
pipe index is the fastest, so a pipe group is a run of consecutive
ranks; with pipe = 1 a seq group is, and with fsdp = tensor = pipe = 1
the layout is the data-major one of the data x seq mesh. ``make_mesh``
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
# the axes, in JAX's device order
MESH_AXES = AXES


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
    """This process's place on the data x fsdp x tensor x seq x pipe
    mesh: the axis sizes, its index on each, and the process groups of
    the axes it communicates over (None on one process)."""
    data: int = 1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    pipe: int = 1
    data_index: int = 0
    fsdp_index: int = 0
    tensor_index: int = 0
    seq_index: int = 0
    pipe_index: int = 0
    seq_ranks: List[int] = dataclasses.field(default_factory=lambda: [0])
    # the global ranks of this rank's pipe group, by stage
    pipe_ranks: List[int] = dataclasses.field(default_factory=lambda: [0])
    seq_group: Optional[object] = None      # ProcessGroup of the seq axis
    fsdp_group: Optional[object] = None
    tensor_group: Optional[object] = None
    pipe_group: Optional[object] = None
    # every rank of this tensor and pipe index (data x fsdp x seq: the
    # batch ranks and the seq ranks that split each batch's frames): the
    # ranks whose gradients of a tensor-replicated parameter and whose
    # metrics are summed (the pipe ranks hold whole gradients of the
    # parameters they share, parallel/pipeline.py)
    replica_group: Optional[object] = None
    # data x seq at this fsdp, tensor and pipe index: the ranks whose
    # shards of an fsdp-sharded parameter are summed after the
    # reduce-scatter
    shard_replica_group: Optional[object] = None

    @property
    def prev_stage_rank(self) -> Optional[int]:
        """The global rank of the previous pipeline stage (None on the
        first)."""
        return (self.pipe_ranks[self.pipe_index - 1] if self.pipe_index > 0
                else None)

    @property
    def next_stage_rank(self) -> Optional[int]:
        """The global rank of the next pipeline stage (None on the
        last)."""
        return (self.pipe_ranks[self.pipe_index + 1]
                if self.pipe_index < self.pipe - 1 else None)

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
    """The rank at ``coords`` on a mesh of ``shape`` (JAX's device order;
    an axis ``shape`` leaves out has one rank)."""
    r = 0
    for axis in MESH_AXES:
        r = r * shape.get(axis, 1) + coords.get(axis, 0)
    return r


def mesh_coords(shape: Dict[str, int], rank: int) -> Dict[str, int]:
    out = {}
    for axis in reversed(MESH_AXES):
        out[axis] = rank % shape.get(axis, 1)
        rank //= shape.get(axis, 1)
    return out


def axis_groups(shape: Dict[str, int], axes: Sequence[str]) -> List[List[int]]:
    """The rank lists of every group spanning ``axes`` (the other axes
    fixed), in a fixed order."""
    rest = [a for a in MESH_AXES if a not in axes]
    groups = []
    for fixed in itertools.product(*(range(shape.get(a, 1)) for a in rest)):
        coords = dict(zip(rest, fixed))
        ranks = []
        for free in itertools.product(*(range(shape.get(a, 1))
                                        for a in axes)):
            coords.update(zip(axes, free))
            ranks.append(mesh_rank(shape, coords))
        groups.append(sorted(ranks))
    return groups


def _my_group(shape, axes, rank):
    """Create every group spanning ``axes`` (each process must create
    every group, in the same order) and return the one holding
    ``rank``, or None where the axes hold one rank."""
    import torch.distributed as dist
    if all(shape.get(a, 1) == 1 for a in axes):
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
    if mesh_cfg.pipe > 1 and mesh_cfg.seq > 1:
        # the JAX package's words (parallel/pipeline.py)
        raise ValueError(
            f"pipeline_parallel cannot compose with seq={mesh_cfg.seq}: "
            "context parallelism is its own manual shard_map over 'seq' "
            "(parallel/context.py) and cannot nest inside the pipeline's "
            "shard_map region")
    n = process_count()
    per = mesh_cfg.fsdp * mesh_cfg.tensor * mesh_cfg.seq * mesh_cfg.pipe
    data = mesh_cfg.data if mesh_cfg.data > 0 else n // max(per, 1)
    if min(mesh_cfg.fsdp, mesh_cfg.tensor, mesh_cfg.seq,
           mesh_cfg.pipe) < 1 or data * per != n:
        raise ValueError(
            f"mesh data {data} x fsdp {mesh_cfg.fsdp} x tensor "
            f"{mesh_cfg.tensor} x seq {mesh_cfg.seq} x pipe "
            f"{mesh_cfg.pipe} != {n} processes")
    if n == 1:
        _MESH = Mesh()
        return _MESH
    shape = dict(data=data, fsdp=mesh_cfg.fsdp, tensor=mesh_cfg.tensor,
                 seq=mesh_cfg.seq, pipe=mesh_cfg.pipe)
    rank = process_index()
    c = mesh_coords(shape, rank)
    seq_ranks = [mesh_rank(shape, dict(c, seq=j)) for j in range(shape["seq"])]
    pipe_ranks = [mesh_rank(shape, dict(c, pipe=j))
                  for j in range(shape["pipe"])]
    groups = {name: _my_group(shape, axes, rank) for name, axes in (
        ("seq", ("seq",)), ("fsdp", ("fsdp",)), ("tensor", ("tensor",)),
        ("pipe", ("pipe",)),
        ("replica", ("data", "fsdp", "seq")),
        ("shard_replica", ("data", "seq")))}
    _MESH = Mesh(**shape, data_index=c["data"], fsdp_index=c["fsdp"],
                 tensor_index=c["tensor"], seq_index=c["seq"],
                 pipe_index=c["pipe"], seq_ranks=seq_ranks,
                 pipe_ranks=pipe_ranks,
                 **{f"{k}_group": g for k, g in groups.items()})
    return _MESH


def get_mesh() -> Mesh:
    """The installed mesh, or one rank when none was made."""
    return _MESH if _MESH is not None else Mesh()


def seq_parallel_active(config) -> bool:
    """Whether an uncached forward of ``config`` runs context-parallel:
    ``sequence_parallel`` set and the seq axis wider than one rank."""
    return bool(config.get("sequence_parallel")) and get_mesh().seq > 1
