"""The device mesh (counterpart of owl_audio_exps_tpu/parallel/mesh.py).

The JAX package names five axes, ``data``, ``fsdp``, ``tensor``, ``seq``
and ``pipe``; the port runs ``data`` (each data rank its own batch,
gradients averaged) and ``seq`` (context parallelism: each seq rank holds
one contiguous slice of the frames, parallel/context.py). ``fsdp``,
``tensor`` and ``pipe`` above 1 raise (a later slice). As in the JAX
package, ``data: -1`` takes every process the other axes leave.

Ranks are laid out data-major: rank = data_index * seq + seq_index, so a
seq group is a run of consecutive ranks. ``make_mesh`` installs the mesh
for the process (``get_mesh`` reads it, as the JAX package's model code
reads its global mesh); without a process group the mesh is one rank.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from .dist import process_count, process_index

AXES = ("data", "fsdp", "tensor", "seq", "pipe")


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
    """This process's place on the data x seq mesh."""
    data: int = 1
    seq: int = 1
    data_index: int = 0
    seq_index: int = 0
    seq_ranks: List[int] = dataclasses.field(default_factory=lambda: [0])
    seq_group: Optional[object] = None   # ProcessGroup of the seq axis
    device_mesh: Optional[object] = None

    def seq_frames(self, n_frames: int):
        """[start, stop) of the frames this rank holds."""
        if n_frames % self.seq:
            raise ValueError(f"{n_frames} frames do not split over "
                             f"{self.seq} seq ranks")
        per = n_frames // self.seq
        return self.seq_index * per, (self.seq_index + 1) * per


_MESH: Optional[Mesh] = None


def make_mesh(mesh_cfg: Optional[MeshConfig] = None,
              device_type: str = "cuda") -> Mesh:
    """Build (and install) the mesh over the process group."""
    global _MESH
    mesh_cfg = mesh_cfg or MeshConfig()
    for axis in ("fsdp", "tensor", "pipe"):
        if getattr(mesh_cfg, axis) != 1:
            raise NotImplementedError(
                f"mesh axis {axis} = {getattr(mesh_cfg, axis)}: the port "
                "runs data and seq parallelism; fsdp, tensor and pipe come "
                "with a later slice (ROADMAP.md Queue 1)")
    n = process_count()
    seq = mesh_cfg.seq
    data = mesh_cfg.data if mesh_cfg.data > 0 else n // max(seq, 1)
    if seq < 1 or data * seq != n:
        raise ValueError(f"mesh data {data} x seq {seq} != {n} processes")
    if n == 1:
        _MESH = Mesh()
        return _MESH
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(device_type, (data, seq),
                          mesh_dim_names=("data", "seq"))
    rank = process_index()
    _MESH = Mesh(data=data, seq=seq, data_index=rank // seq,
                 seq_index=rank % seq,
                 seq_ranks=[(rank // seq) * seq + j for j in range(seq)],
                 seq_group=dm.get_group("seq"), device_mesh=dm)
    if dm.get_local_rank("seq") != _MESH.seq_index:
        raise RuntimeError("device mesh layout is not data-major")
    return _MESH


def get_mesh() -> Mesh:
    """The installed mesh, or one rank when none was made."""
    return _MESH if _MESH is not None else Mesh()


def seq_parallel_active(config) -> bool:
    """Whether an uncached forward of ``config`` runs context-parallel:
    ``sequence_parallel`` set and the seq axis wider than one rank."""
    return bool(config.get("sequence_parallel")) and get_mesh().seq > 1

