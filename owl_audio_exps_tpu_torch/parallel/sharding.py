"""Parameter sharding rules over the fsdp and tensor axes (counterpart of
owl_audio_exps_tpu/parallel/sharding.py).

The JAX package derives every parameter's sharding from its tree path
(``RULES``, first match wins, each axis kept only where it divides the
dimension: ``spec_for_path``, copied here). The port keeps the rules and
maps its own ``state_dict`` names onto JAX's paths (``jax_path``:
``transformer.blocks.3.attn.qkv.weight`` -> ``transformer/blocks_3/attn/
qkv/kernel``, the map of utils/weights.py ``params_from_jax``). A torch
weight is [out, in], the transpose of JAX's [in, out] kernel, so JAX's
``P(fsdp, tensor)`` shards torch dim 1 over fsdp and dim 0 over tensor
(``ShardSpec.axes`` lists the axis of each torch dim).

The port's fused QKV rows are in the reference order [3, H, Dh], while
JAX packs them heads-major [H, 3, Dh] (nn/attn.py). A tensor rank holds
JAX's contiguous block of the packed rows, which in the port's order is
three strided blocks, one each of q, k and v (``ShardSpec.indices``);
kept in ascending order they lay out as [3, H/T, Dh] when T divides H.

``shard_params`` replaces each sharded weight of a module by this rank's
slice (the full weights are built alike on every rank from the seed
first) and tags it with its ``shard_spec``; nn/layers.py ``Linear`` then
gathers an fsdp-sharded weight where it is used (its gradient
reduce-scattered, parallel/dist.py) and runs column-parallel (``qkv``,
``fc1``: input replicated over tensor, output local) or row-parallel
(``out``, ``fc2``: input local, output summed over tensor, the psum GSPMD
inserts) by the tensor axis of its weight. ``gather_params`` rebuilds
the full tensors; ``cache_shardings`` / ``shard_cache`` lay a ring
cache's heads over tensor and its batch over data.

The pipe axis (parallel/pipeline.py): JAX splits the ``scan_layers``
group stack over the stages (``spec_for_path``: a leaf under
``groups/`` shards its leading group dim over ``pipe`` and the rules
above apply to the per-group dims). The port keeps its blocks unrolled,
so there the rule reads "block i lives on stage i // (n / K)":
``shard_params`` drops the blocks of the other stages from a DiT whose
forward runs the pipeline (``pipeline_active``) and tags every block
parameter it keeps with its ``pipe_stage``; the fsdp and tensor rules
then apply to what stays. ``gather_stages`` collects every stage's
tensors by name.
"""

from __future__ import annotations

import copy
import dataclasses
import re
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..utils.weights import _LISTS
from .dist import all_gather, all_reduce, copy_to_group, gather_dim
from .mesh import Mesh, get_mesh

AXIS_DATA, AXIS_FSDP, AXIS_TENSOR, AXIS_PIPE = ("data", "fsdp", "tensor",
                                             "pipe")

# ordered: first match wins (JAX layout: kernels [in, out])
RULES = [
    # column-parallel (shard outputs over tensor; fsdp on inputs)
    (r"attn/qkv/kernel$", (AXIS_FSDP, AXIS_TENSOR)),
    (r"attn/qkv/bias$", (AXIS_TENSOR,)),
    (r"mlp/.*fc1/kernel$", (AXIS_FSDP, AXIS_TENSOR)),
    (r"mlp/.*fc1/bias$", (AXIS_TENSOR,)),
    # row-parallel (shard inputs over tensor; fsdp on outputs)
    (r"attn/out/kernel$", (AXIS_TENSOR, AXIS_FSDP)),
    (r"mlp/.*fc2/kernel$", (AXIS_TENSOR, AXIS_FSDP)),
    # modulation / embedding / projection matrices: fsdp over inputs
    (r"kernel$", (AXIS_FSDP, None)),
    (r"embedding$", (AXIS_FSDP, None)),
]


def _sizes(mesh) -> Dict[str, int]:
    if isinstance(mesh, dict):
        return mesh
    return dict(data=mesh.data, fsdp=mesh.fsdp, tensor=mesh.tensor,
                seq=mesh.seq, pipe=mesh.pipe)


def spec_for_path(path: str, shape, mesh) -> Tuple[Optional[str], ...]:
    """Rule lookup with a divisibility guard: a mesh axis only applies to
    a dimension it divides evenly (odd-sized embeddings replicate). The
    JAX package's function over the JAX layout: with an engaged pipe
    axis a scan-stacked group leaf (under ``groups/``, leading dim the
    group count) shards that dim over ``pipe`` (where it divides) and the
    rules apply to the per-group dims. ``mesh`` is a Mesh or a dict of
    axis sizes."""
    sizes = _sizes(mesh)
    n_pipe = sizes.get(AXIS_PIPE, 1)
    stacked = n_pipe > 1 and "groups/" in path and len(shape) >= 1
    inner = tuple(shape[1:]) if stacked else tuple(shape)
    lead = ((AXIS_PIPE if shape[0] % n_pipe == 0 else None),) \
        if stacked else ()
    for pattern, spec in RULES:
        if re.search(pattern, path):
            if len(spec) > len(inner):
                break
            return lead + tuple(
                axis if axis is None or inner[i] % sizes[axis] == 0
                else None for i, axis in enumerate(spec))
    return lead


def jax_path(name: str, ndim: int) -> str:
    """The JAX package's parameter path of a port ``state_dict`` name
    (``blocks.3`` -> ``blocks_3``; a 2-D ``weight`` is a ``kernel``, a
    1-D one a norm's ``scale``)."""
    parts = name.split(".")
    out, i = [], 0
    while i < len(parts) - 1:
        if parts[i] in _LISTS and parts[i + 1].isdigit():
            out.append(f"{parts[i]}_{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    leaf = parts[-1]
    if leaf == "weight":
        leaf = "kernel" if ndim >= 2 else "scale"
    return "/".join(out + [leaf])


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """How one parameter lies over the mesh: its full torch ``shape``, the
    mesh axis of each torch dim (None: whole), the axis sizes, and for a
    fused QKV (``qkv_heads`` = H) that dim 0 holds [3, H, Dh] rows which
    the tensor axis splits as JAX's [H, 3, Dh]."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    sizes: Tuple[Tuple[str, int], ...]
    qkv_heads: int = 0

    @property
    def sharded(self) -> bool:
        return any(a is not None for a in self.axes)

    def size(self, axis: Optional[str]) -> int:
        return 1 if axis is None else dict(self.sizes)[axis]

    @property
    def n_shards(self) -> int:
        n = 1
        for a in self.axes:
            n *= self.size(a)
        return n

    def indices(self, dim: int, k: int) -> torch.Tensor:
        """The rows along ``dim`` held by index ``k`` of that dim's axis."""
        full, n = self.shape[dim], self.size(self.axes[dim])
        per = full // n
        j = torch.arange(k * per, (k + 1) * per)
        if dim == 0 and self.qkv_heads and self.axes[0] == AXIS_TENSOR:
            # JAX's packed column j = (h, s, e) -> the port's row (s, h, e)
            dh = full // 3 // self.qkv_heads
            h, s, e = j // (3 * dh), (j // dh) % 3, j % dh
            j = torch.sort(s * self.qkv_heads * dh + h * dh + e).values
        return j

    def shard(self, full: torch.Tensor, coords: Dict[str, int]
              ) -> torch.Tensor:
        """The slice of ``full`` at mesh ``coords`` ({axis: index})."""
        out = full
        for dim, axis in enumerate(self.axes):
            if axis is not None:
                idx = self.indices(dim, coords[axis]).to(full.device)
                out = out.index_select(dim, idx)
        return out.contiguous()

    def gather(self, local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        """The full tensor from every rank's slice (a collective over the
        axes of its dims)."""
        out = local
        for dim, axis in enumerate(self.axes):
            if axis is None:
                continue
            out = gather_dim(out, dim, mesh.group(axis))
            idx = torch.cat([self.indices(dim, k)
                             for k in range(self.size(axis))])
            if not torch.equal(idx, torch.arange(len(idx))):
                out = out.index_select(dim, torch.argsort(idx).to(
                    out.device))
        return out

    def assemble(self, parts) -> torch.Tensor:
        """The full tensor from every rank's slice, held by one process:
        ``parts`` [(coords, slice)] as ``shard`` cut them."""
        out = None
        for coords, t in parts:
            if out is None:
                out = t.new_empty(self.shape)
            idx = [torch.arange(n) if a is None else self.indices(d, coords[a])
                   for d, (n, a) in enumerate(zip(self.shape, self.axes))]
            out[torch.meshgrid(*(i.to(t.device) for i in idx),
                               indexing="ij")] = t
        return out


def param_spec(name: str, shape: Sequence[int], mesh,
               n_heads: int = 0) -> ShardSpec:
    """The ShardSpec of the port's parameter ``name`` of torch ``shape``
    on ``mesh`` (a Mesh or a dict of axis sizes); ``n_heads`` is the
    model's, for the fused QKV rows."""
    sizes = _sizes(mesh)
    shape = tuple(shape)
    kernel = len(shape) == 2 and name.endswith("weight")
    jshape = shape[::-1] if kernel else shape
    path = jax_path(name, len(shape))
    # the port's unrolled blocks: the stage split is shard_params' (the
    # fsdp and tensor rules of a stage's block are the unstacked ones)
    jspec = spec_for_path(path, jshape, dict(sizes, pipe=1))
    # an axis of one rank shards nothing
    jspec = tuple(a if a is not None and sizes[a] > 1 else None
                  for a in jspec) + (None,) * (len(shape) - len(jspec))
    axes = jspec[::-1] if kernel else jspec
    qkv = bool(re.search(r"attn/qkv/(kernel|bias)$", path))
    return ShardSpec(shape=shape, axes=tuple(axes),
                     sizes=tuple(sorted(sizes.items())),
                     qkv_heads=n_heads if qkv else 0)


def _n_heads(module: torch.nn.Module) -> int:
    for m in module.modules():
        cfg = getattr(m, "config", None)
        if cfg is not None and cfg.get("n_heads"):
            return int(cfg.n_heads)
    return 0


def param_specs(module: torch.nn.Module, mesh=None,
                n_heads: Optional[int] = None) -> Dict[str, ShardSpec]:
    """{name: ShardSpec} of every parameter of ``module`` (full shapes)."""
    mesh = mesh or get_mesh()
    n_heads = _n_heads(module) if n_heads is None else n_heads
    return {name: param_spec(name, p.shape, mesh, n_heads)
            for name, p in module.named_parameters()}


def _check_tensor_layout(module: torch.nn.Module, specs, mesh):
    """The port runs tensor parallelism on whole heads and hidden units:
    a column-parallel layer and its row-parallel partner are sharded over
    tensor together, and a QKV's shard holds whole heads."""
    if mesh.tensor == 1:
        return
    pairs = [(n[:-len("qkv.weight")], "qkv", "out")
             for n in specs if n.endswith("attn.qkv.weight")]
    pairs += [(n[:-len("fc1.weight")], "fc1", "fc2")
              for n in specs if n.endswith("fc1.weight")]
    for prefix, col, row in pairs:
        c = specs[f"{prefix}{col}.weight"].axes[0] == AXIS_TENSOR
        r = specs[f"{prefix}{row}.weight"].axes[1] == AXIS_TENSOR
        if c != r:
            raise ValueError(
                f"{prefix}{col} and {prefix}{row}: one is sharded over "
                f"tensor {mesh.tensor} and the other not; the port runs "
                "tensor parallelism on whole heads and hidden units")
        heads = specs[f"{prefix}{col}.weight"].qkv_heads
        if c and heads and heads % mesh.tensor:
            raise ValueError(
                f"{prefix}{col}: {heads} heads do not split over tensor "
                f"{mesh.tensor}; the port runs tensor parallelism on whole "
                "heads")


def mesh_coords_of(mesh: Mesh) -> Dict[str, int]:
    return dict(data=mesh.data_index, fsdp=mesh.fsdp_index,
                tensor=mesh.tensor_index, seq=mesh.seq_index,
                pipe=mesh.pipe_index)


def split_stages(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Drop from every DiT of ``module`` whose forward runs the pipeline
    the blocks of the other stages (built on the meta device when the DiT
    was made under this mesh, nn/attn.py), and tag the parameters of the
    blocks kept with ``pipe_stage`` (in place)."""
    from ..nn.attn import DiT
    from .pipeline import pipeline_active, stage_blocks
    for m in module.modules():
        if not (isinstance(m, DiT) and pipeline_active(m.config, mesh)):
            continue
        keep = stage_blocks(m.config, mesh.pipe, mesh.pipe_index)
        for i in range(len(m.blocks)):
            if i not in keep:
                m.blocks[i] = None
            elif m.blocks[i] is not None:
                for p in m.blocks[i].parameters():
                    p.pipe_stage = mesh.pipe_index
    return module


def stage_of(p: torch.Tensor) -> Optional[int]:
    """The pipeline stage that alone holds ``p`` (None: every stage)."""
    return getattr(p, "pipe_stage", None)


@torch.no_grad()
def shard_params(module: torch.nn.Module, mesh: Optional[Mesh] = None,
                 n_heads: Optional[int] = None) -> torch.nn.Module:
    """Keep this rank's stage of a pipelined DiT's blocks
    (``split_stages``) and this rank's slice of every sharded parameter of
    ``module`` (in place; each becomes a new Parameter tagged with its
    ``shard_spec``, and keeps its ``pipe_stage``). The ranks of a stage
    must hold the same full weights before. Returns ``module``."""
    mesh = mesh or get_mesh()
    split_stages(module, mesh)
    specs = param_specs(module, mesh, n_heads)
    _check_tensor_layout(module, specs, mesh)
    coords = mesh_coords_of(mesh)
    for name, spec in specs.items():
        if not spec.sharded:
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        p = getattr(owner, leaf)
        new = torch.nn.Parameter(spec.shard(p.detach(), coords),
                                 requires_grad=p.requires_grad)
        new.shard_spec = spec
        if stage_of(p) is not None:
            new.pipe_stage = stage_of(p)
        setattr(owner, leaf, new)
    return module


def spec_of(p: torch.Tensor) -> Optional[ShardSpec]:
    return getattr(p, "shard_spec", None)


@torch.no_grad()
def gather_tensor(t: torch.Tensor, spec: Optional[ShardSpec],
                  mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The full tensor of a shard laid out by ``spec`` (a collective; the
    tensor itself where ``spec`` is None or shards nothing)."""
    if spec is None or not spec.sharded:
        return t
    return spec.gather(t, mesh or get_mesh())


@torch.no_grad()
def gather_params(module: torch.nn.Module, mesh: Optional[Mesh] = None,
                  device=None) -> Dict[str, torch.Tensor]:
    """The full ``state_dict`` of a sharded module, on every rank (one
    parameter at a time, each moved to ``device`` when given); with a
    pipe axis every stage's blocks too (``gather_stages``, through the
    host: the other stages' tensors arrive on the CPU unless ``device``
    is given)."""
    mesh = mesh or get_mesh()
    out = {}
    for name, p in module.named_parameters():
        full = gather_tensor(p.detach(), spec_of(p), mesh)
        out[name] = full if device is None else full.to(device)
    if mesh.pipe_group is not None:
        merged = gather_stages({n: t.cpu() for n, t in out.items()}, mesh)
        out = {n: out[n] if n in out else
               (t if device is None else t.to(device))
               for n, t in merged.items()}
    return out


def gather_stage_list(obj, mesh: Optional[Mesh] = None) -> list:
    """Every pipeline stage's ``obj`` (picklable; tensors best on the
    CPU), in stage order, on every rank of this rank's pipe group
    ([obj] without a pipe axis). A collective over the pipe group."""
    import torch.distributed as dist
    mesh = mesh or get_mesh()
    if mesh.pipe_group is None:
        return [obj]
    parts = [None] * mesh.pipe
    dist.all_gather_object(parts, obj, group=mesh.pipe_group)
    return parts


class _Slot(int):
    """A tensor's place in ``collect_stage_list``'s transfer order."""


def collect_stage_list(obj, mesh: Optional[Mesh] = None) -> Optional[list]:
    """Every pipeline stage's ``obj`` (picklable; tensors anywhere in its
    dicts, lists and tuples), in stage order, on the first rank of this
    rank's pipe group, and None on the others ([obj] without a pipe
    axis). The structure travels pickled, the tensors one at a time from
    each stage to the first (through the card under NCCL), each landing
    on the CPU. A collective over the pipe group."""
    import torch.distributed as dist
    mesh = mesh or get_mesh()
    if mesh.pipe_group is None:
        return [obj]
    tensors = []

    def strip(x):
        if torch.is_tensor(x):
            tensors.append(x)
            return _Slot(len(tensors) - 1)
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(strip(v) for v in x)
        return x

    skeleton = strip(obj)
    first = mesh.pipe_ranks[0]
    is_first = mesh.pipe_index == 0
    heads = [None] * mesh.pipe if is_first else None
    dist.gather_object((skeleton, [(t.shape, t.dtype) for t in tensors]),
                       heads, dst=first, group=mesh.pipe_group)
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend(mesh.pipe_group) == "nccl"
              else torch.device("cpu"))
    if not is_first:
        for t in tensors:
            dist.send(t.detach().to(device).contiguous(), first)
        return None
    parts = [obj]
    for stage, (skel, shapes) in enumerate(heads[1:], 1):
        got = []
        for shape, dtype in shapes:
            buf = torch.empty(shape, dtype=dtype, device=device)
            dist.recv(buf, mesh.pipe_ranks[stage])
            got.append(buf.cpu())

        def fill(x):
            if isinstance(x, _Slot):
                return got[x]
            if isinstance(x, dict):
                return {k: fill(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(fill(v) for v in x)
            return x

        parts.append(fill(skel))
    return parts


def gather_stages(tree: Dict[str, object], mesh: Optional[Mesh] = None
                  ) -> Dict[str, object]:
    """Every pipeline stage's ``tree`` ({name: value}) merged into one
    dict on every rank of this rank's pipe group (``gather_stage_list``)."""
    out = {}
    for part in gather_stage_list(dict(tree), mesh):
        out.update(part)
    return out


# ------------------------------------------------------------ the layers

def sharded_linear(layer, x: torch.Tensor) -> torch.Tensor:
    """``Linear.forward`` of a layer whose weight carries a shard_spec:
    fsdp dims gathered (in the compute dtype, the gradient reduce-
    scattered in float32), then column-parallel, row-parallel or plain by
    the weight's tensor axis."""
    mesh = get_mesh()
    w, spec = layer.weight, layer.weight.shard_spec
    dtype = layer.dtype
    for dim, axis in enumerate(spec.axes):
        if axis == AXIS_FSDP:
            w = all_gather(w, dim, mesh.fsdp_group, dtype)
    w = w.to(dtype)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    x = x.to(dtype)
    if spec.axes[0] == AXIS_TENSOR:     # column-parallel
        return torch.nn.functional.linear(
            copy_to_group(x, mesh.tensor_group), w, bias)
    if spec.axes[1] == AXIS_TENSOR:     # row-parallel
        y = all_reduce(torch.nn.functional.linear(x, w), mesh.tensor_group)
        return y if bias is None else y + bias
    return torch.nn.functional.linear(x, w, bias)


# ----------------------------------------------------------- the KV cache

def cache_shardings(cache, mesh: Optional[Mesh] = None) -> Dict[str, tuple]:
    """{field: spec} of a ring KVCache (nn/kv_cache.py): rings (and int8
    scales) [L, B, H, S, Dh] shard batch over data and heads over tensor
    (each divisibility-guarded), the counters replicate (every rank
    advances the same clock)."""
    mesh = mesh or get_mesh()
    out = {}
    for name, leaf in vars(cache).items():
        if not torch.is_tensor(leaf):
            continue
        if leaf.ndim == 5:
            b, h = leaf.shape[1], leaf.shape[2]
            out[name] = (None,
                         AXIS_DATA if b % mesh.data == 0 else None,
                         AXIS_TENSOR if h % mesh.tensor == 0 else None,
                         None, None)
        else:
            out[name] = ()
    return out


def shard_cache(cache, mesh: Optional[Mesh] = None):
    """A copy of a full ring KVCache holding this rank's batch rows and
    heads (``cache_shardings``)."""
    mesh = mesh or get_mesh()
    coords = mesh_coords_of(mesh)
    out = copy.copy(cache)
    for name, spec in cache_shardings(cache, mesh).items():
        leaf = getattr(cache, name)
        for dim, axis in enumerate(spec):
            if axis is not None:
                n = leaf.shape[dim] // mesh.size(axis)
                leaf = leaf.narrow(dim, coords[axis] * n, n)
        setattr(out, name, leaf.contiguous())
    return out

