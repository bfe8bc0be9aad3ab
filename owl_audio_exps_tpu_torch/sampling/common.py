"""Shared sampler utilities (counterpart of
owl_audio_exps_tpu/sampling/common.py), and the step loop of the cached
samplers and serve pipelines.

``StepLoop`` is this package's counterpart of the JAX package's one
jitted ``lax.scan`` (or one jitted tick): a subclass keeps the static
buffers of a generation (the ring cache and its device counters, the
pending write, the run's draws indexed by a device-side counter, the
outputs) and defines one step on them, which reads no value back to the
host. On a CUDA device ``run`` takes a few eager steps on a side stream
(one per device, shared by every loop), then captures one step there as
a ``torch.cuda.CUDAGraph`` and replays it for every later step; on the
CPU the step runs eagerly. A capture that syncs the host (``.item()``,
``bool(tensor)``, a CPU tensor sent to the card) raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

# eager steps on a side stream before the capture
WARMUP_STEPS = 3
# the side stream of each device on which every loop warms up and is
# captured: each stream that runs a cuBLAS call keeps a workspace of its
# own for the life of the process, so the loops share one
_SIDE_STREAMS = {}


def side_stream(device) -> torch.cuda.Stream:
    """The shared side stream of a CUDA device."""
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _SIDE_STREAMS:
        _SIDE_STREAMS[index] = torch.cuda.Stream(index)
    return _SIDE_STREAMS[index]


def randn(shape, dtype, device, generator: Optional[torch.Generator]):
    """float32 normal noise cast to ``dtype``."""
    return torch.randn(shape, dtype=torch.float32, device=device,
                       generator=generator).to(dtype)


def zlerp(x: torch.Tensor, alpha: float,
          generator: Optional[torch.Generator] = None,
          z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Partial re-noising: x * (1 - alpha) + z * alpha, with the float32
    draw ``z`` (cast to x's dtype) given or taken from ``generator``."""
    if z is None:
        z = randn(x.shape, x.dtype, x.device, generator)
    return x * (1.0 - alpha) + z.to(x.device, x.dtype) * alpha


class SamplerNoise(NamedTuple):
    """A cached sampler's float32 draws, in the JAX samplers' split order:
    the context's re-noise, then each new step's initial and re-noise
    draws (a step is one token of the audio sampler, one frame of the
    video samplers)."""
    ctx: torch.Tensor      # [b, init_len, *item]
    init: torch.Tensor     # [num, b, 1, *item]
    renoise: torch.Tensor  # [num, b, 1, *item]


def draw_noise(generator: Optional[torch.Generator], batch: int,
               init_len: int, item: Union[int, Tuple[int, ...]], num: int,
               device) -> SamplerNoise:
    """A run's float32 draws from ``generator``; ``item`` is the shape of
    one token or frame (channels, or (c, h, w))."""
    item = (item,) if isinstance(item, int) else tuple(item)
    ctx = torch.randn((batch, init_len) + item, generator=generator,
                      device=device)
    steps = torch.randn((num, 2, batch, 1) + item, generator=generator,
                        device=device)
    return SamplerNoise(ctx, steps[:, 0], steps[:, 1])


def check_noise(noise: SamplerNoise, **want):
    """Raise ValueError unless each named draw has its wanted shape."""
    for name, shape in want.items():
        got = tuple(getattr(noise, name).shape)
        if got != tuple(shape):
            raise ValueError(f"noise.{name} has shape {got}, the run needs "
                             f"{tuple(shape)}")


_GRAPH_DECISION_PRINTED = []


def graphs_allowed(device) -> bool:
    """Whether a loop on ``device`` replays its step from a CUDA graph:
    on a CUDA device, unless the installed mesh shards the weights (fsdp
    or tensor above 1, parallel/sharding.py). Each step of such a mesh
    runs NCCL collectives (the fsdp gathers, the row-parallel sums), which
    the port does not capture, so it runs eagerly; that decision is
    printed once a process."""
    if torch.device(device).type != "cuda":
        return False
    from ..parallel.mesh import get_mesh
    mesh = get_mesh()
    if mesh.fsdp * mesh.tensor == 1:
        return True
    if not _GRAPH_DECISION_PRINTED:
        _GRAPH_DECISION_PRINTED.append(True)
        print(f"[serve] eager steps: the mesh (fsdp {mesh.fsdp}, tensor "
              f"{mesh.tensor}) puts NCCL collectives in every step, which "
              "are not captured as CUDA graphs", flush=True)
    return False


class StepLoop:
    """Static buffers and one step on them (``step(core, *args)``), run
    eagerly or replayed from a CUDA graph; see the module docstring. Each
    ``args`` (e.g. a step count) has its own graph."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.graphs = {}   # args -> captured CUDAGraph
        self.warm = {}     # args -> eager warm-up steps taken

    @property
    def graph(self) -> Optional[torch.cuda.CUDAGraph]:
        """The graph of the step without arguments, once captured."""
        return self.graphs.get(())

    def step(self, core, *args):
        raise NotImplementedError

    def run(self, core, n: int, graphed: bool, *args):
        """Take ``n`` steps: eagerly, or (``graphed``, a CUDA device) by
        replaying the captured step, after ``WARMUP_STEPS`` eager steps on
        a side stream and one capture."""
        if not graphed:
            for _ in range(n):
                self.step(core, *args)
            return
        graph = self.graphs.get(args)
        if graph is None:
            current = torch.cuda.current_stream(self.device)
            side = side_stream(self.device)
            while n and self.warm.get(args, 0) < WARMUP_STEPS:
                side.wait_stream(current)
                with torch.cuda.stream(side):
                    self.step(core, *args)
                current.wait_stream(side)
                self.warm[args] = self.warm.get(args, 0) + 1
                n -= 1
            if n == 0:
                return
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, stream=side):
                    self.step(core, *args)
            except RuntimeError as e:
                raise RuntimeError(
                    f"{type(self).__name__}: the step could not be captured "
                    "as a CUDA graph (it must not sync the host)") from e
            self.graphs[args] = graph
        for _ in range(n):
            graph.replay()
