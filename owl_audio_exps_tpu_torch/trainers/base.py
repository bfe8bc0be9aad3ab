"""Trainer foundation (counterpart of owl_audio_exps_tpu/trainers/base.py):
train state, optimizer factory, the grad-accumulating train step,
checkpoint save/resume and the preemption handler.

The state is the model (float32 master parameters, bf16 compute), an EMA
copy (float32 unless ``ema_dtype``), the optimizer and the step count. A
step accumulates gradients over ``target_batch_size // batch_size``
micro-batches, clips the global norm to 10 for every optimizer but Muon,
updates, and moves the EMA towards the parameters with beta 0.999, as the
JAX package's one jitted step does. With ``train.watch`` the step also
returns the per-module parameter and gradient norms (and, under
``full``, histograms of ``watch_bins`` bins) of the clipped gradients
before the update (utils/telemetry.py), on any mesh (``watch``).
Parameters and optimizer state are updated in place.

Several processes (one per device, under ``torchrun``; parallel/dist.py)
form the mesh of ``train.mesh`` (parallel/mesh.py): the batch ranks (data
x fsdp) draw distinct batches, the tensor and seq ranks of one batch rank
the same batch; a seq rank computes its slice of the frames (context
parallelism), a tensor rank its share of the heads and MLP hidden.
Under the fsdp and tensor axes ``make_state`` keeps each rank's slice of
the parameters, the EMA and (as the optimizer creates them) every
moment, by the rules of parallel/sharding.py, as the JAX package's
``_opt_shardings`` lays an optax state like its params; every rank first
builds the same full weights from the seed (under the pipe axis, its
stage's blocks only). The gradients and metrics
are summed over the ranks that hold the same elements and divided by
the number of batch ranks before the clip and the optimizer, so every
rank takes the same step: seq ranks hold shares of one loss, batch ranks
average theirs, and an fsdp shard's gradient arrives summed over fsdp
from the reduce-scatter of its gather (parallel/dist.py). Tensor ranks
hold the same gradient of every parameter they share: the column-
parallel layers' replicated input sums its gradient over tensor in the
backward, so no shared parameter's gradient is partial there and none is
summed over tensor. The pipe ranks (parallel/pipeline.py) take the same
batch; a pipe rank keeps its stage's blocks (with their EMA and moments)
and every parameter the stages share, whose whole gradient it holds (the
pipeline sums the stages' parts as they leave the stack), so none is
summed over pipe either. Global norms count each logical element once.
Rank 0 alone logs and writes the full logical state (gathered from every
rank and every stage, the optimizer's moments numbered as one process
numbers them); every rank resumes, re-slicing it onto the live mesh.
"""

from __future__ import annotations

import dataclasses
import os
import signal
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data import get_loader
from ..data.prefetch import device_prefetch
from ..muon import AdamW, chunks, init_muon
from ..parallel.dist import barrier, is_main, process_count
from ..parallel.mesh import (MeshConfig, get_mesh, make_mesh,
                             seq_parallel_active)
from ..parallel.sharding import (collect_stage_list, gather_tensor,
                                 mesh_coords_of, shard_params, spec_of,
                                 stage_of)
from ..schedulers import get_scheduler_cls
from ..utils.checkpoints import (load_checkpoint, save_checkpoint,
                                 save_clean_export)
from ..utils.device import resolve_device
from ..utils.logging import ExperimentLogger, LogHelper, Timer
from ..utils.profiling import span
from ..utils.telemetry import (bin_counts, group_key, value_range,
                               watch_metrics)


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    ema: Dict[str, torch.Tensor]
    optimizer: object
    step: int = 0


def build_optimizer(train_cfg, named_params):
    """opt: 'AdamW' | 'Muon' with the reference's kwargs."""
    named = list(named_params)
    opt_name = (train_cfg.opt or "AdamW").lower()
    kwargs = dict(train_cfg.opt_kwargs.items()) if train_cfg.opt_kwargs \
        else {}
    make_schedule = get_scheduler_cls(train_cfg.scheduler)
    if opt_name == "muon":
        if make_schedule is not None:
            raise NotImplementedError("LR schedules with Muon: set "
                                      "scheduler null (reference parity)")
        return init_muon(named, **kwargs)
    lr = kwargs.pop("lr", 1e-4)
    if make_schedule is not None:
        lr = make_schedule(base_lr=lr, **dict(
            (train_cfg.scheduler_kwargs or {}).items()))
    betas = kwargs.pop("betas", (0.9, 0.999))
    return AdamW([p for _, p in named], lr, betas=tuple(betas),
                 eps=kwargs.pop("eps", 1e-8),
                 weight_decay=kwargs.pop("weight_decay", 0.01))


def global_norm(tensors, specs=None, stages=None) -> torch.Tensor:
    """The L2 norm of ``tensors``. With ``specs`` (one ShardSpec or None
    each) that shard any, or ``stages`` (each tensor's pipeline stage, or
    None where every stage holds it) that name any, the tensors are this
    rank's slices: each slice's squares are weighted by the number of
    ranks that hold a copy of it (the world size over its shard count,
    over the pipe size for a stage's tensor) and summed over every rank,
    so each logical element counts once."""
    tensors = list(tensors)
    specs = list(specs) if specs is not None else [None] * len(tensors)
    stages = list(stages) if stages is not None else [None] * len(tensors)
    if not any(s is not None and s.sharded for s in specs) \
            and all(st is None for st in stages):
        # each tensor's float32 norm as one list reduction, then theirs
        norms = torch._foreach_norm(tensors, dtype=torch.float32)
        return torch.linalg.vector_norm(torch.stack(norms))
    world = process_count()
    pipe = get_mesh().pipe
    total = sum(t.float().pow(2).sum()
                * ((s.n_shards if s else 1) * (pipe if st is not None else 1)
                   / world)
                for t, s, st in zip(tensors, specs, stages))
    total = torch.as_tensor(total, dtype=torch.float32,
                            device=tensors[0].device)
    dist.all_reduce(total)
    return torch.sqrt(total)


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], named_params, beta: float):
    """e <- e beta, then e <- e + p (1 - beta) rounded to e's dtype (p cast
    to it first), for each parameter's EMA ``ema[name]``: each operation
    over the list of a chunk of the EMAs that share a device and dtype
    (muon.py ``chunks``)."""
    pairs = [(ema[n], p) for n, p in named_params]
    for chunk in chunks(pairs, lambda ep: (ep[0].device, ep[0].dtype),
                        lambda ep: ep[0].numel()):
        es = [e for e, _ in chunk]
        step = torch._foreach_mul([p.to(e.dtype) for e, p in chunk],
                                  1.0 - beta)
        torch._foreach_mul_(es, beta)
        torch._foreach_add_(es, step)


def layout_norm(tensors, params) -> torch.Tensor:
    """``global_norm`` of ``tensors`` (the parameters or their gradients),
    each laid out as its parameter's ShardSpec and pipeline stage say."""
    return global_norm(tensors, [spec_of(p) for p in params],
                       [stage_of(p) for p in params])


@torch.no_grad()
def clip_grad_norm(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients by min(1, max_norm / (norm + 1e-6)), as the
    JAX package's step does; returns the norm before clipping."""
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    gnorm = layout_norm(grads, params)
    scale = torch.clamp(max_norm / (gnorm + 1e-6), max=1.0)
    torch._foreach_mul_(grads, scale)
    return gnorm


def _opt_parts(optimizer):
    """[(name, torch optimizer)] of the port's optimizers (a
    CombinedOptimizer's Muon and AdamW, or one optimizer)."""
    if hasattr(optimizer, "muon") and hasattr(optimizer, "adamw"):
        return [(k, o) for k, o in (("muon", optimizer.muon),
                                    ("adamw", optimizer.adamw))
                if o is not None]
    return [(None, optimizer)]


def _map_opt_state(optimizer, fn, state_dict=None):
    """``optimizer``'s state_dict (or ``state_dict``, in place) with
    ``fn(tensor, param)`` applied to every per-parameter tensor of the
    parameter's shape (the moments), keyed as torch numbers them."""
    sd = optimizer.state_dict() if state_dict is None else state_dict
    for key, opt in _opt_parts(optimizer):
        part = sd if key is None else sd[key]
        params = [p for g in opt.param_groups for p in g["params"]]
        # new entry dicts: torch's state_dict shares the live ones
        part["state"] = {
            idx: {k: fn(v, params[idx]) if torch.is_tensor(v)
                  and v.ndim and v.ndim == params[idx].ndim else v
                  for k, v in entry.items()}
            for idx, entry in part["state"].items()}
    return sd


def _opt_names(optimizer, named_params) -> Dict:
    """{part: [the parameter name of each moment index]} of the port's
    optimizer (part None for one torch optimizer)."""
    name_of = {id(p): n for n, p in named_params}
    return {key: [name_of[id(p)] for g in opt.param_groups
                  for p in g["params"]]
            for key, opt in _opt_parts(optimizer)}


def _opt_by_name(state_dict, names) -> Dict:
    """An optimizer state_dict keyed by parameter name: {part: (group
    hyper-parameters, {name: state entry})}. Each part holds one
    parameter group."""
    out = {}
    for key, part_names in names.items():
        part = state_dict if key is None else state_dict[key]
        (group,) = part["param_groups"]
        out[key] = ({k: v for k, v in group.items() if k != "params"},
                    {part_names[i]: e for i, e in part["state"].items()})
    return out


def _opt_from_names(parts, names) -> Dict:
    """The torch state_dict numbered by ``names`` ({part: [name of each
    index]}) from by-name states (``_opt_by_name``; several merge)."""
    out = {}
    for key, part_names in names.items():
        entries = {}
        for part in parts:
            entries.update(part[key][1])
        sd = {"state": {i: entries[n] for i, n in enumerate(part_names)
                        if n in entries},
              "param_groups": [dict(parts[0][key][0],
                                    params=list(range(len(part_names))))]}
        if key is None:
            return sd
        out[key] = sd
    return out


def _saved_opt_names(ema, live, train_cfg) -> Dict:
    """{part: [name of each moment index]} of a checkpoint's optimizer
    state, which numbers the whole model's parameters (the EMA's keys, in
    order) as one process does, part by part as the live optimizer's
    parts (``live``) split them (Muon's labels, muon.py)."""
    names = list(ema)
    if list(live) == [None]:
        return {None: names}
    from ..muon import muon_adamw_labels
    keys = dict((train_cfg.opt_kwargs or {}).items()).get("adamw_keys")
    labels = muon_adamw_labels([(n, ema[n]) for n in names], keys)
    return {part: [n for n in names if labels[n] == part] for part in live}


def _merge_stage_orders(orders, staged) -> List[str]:
    """One process's parameter order from every stage's: the names every
    stage shares around the stages' own (``staged``) in stage order."""
    first = orders[0]
    idx = [i for i, n in enumerate(first) if n in staged]
    if not idx:
        return list(first)
    middle = [n for order in orders for n in order if n in staged]
    return first[:idx[0]] + middle + first[idx[-1] + 1:]


class BaseTrainer:
    """Holds configs, device, logging and checkpoint plumbing."""

    EMA_BETA = 0.999

    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.model_cfg = cfg.model
        self.train_cfg = cfg.train
        self.wandb_cfg = cfg.wandb
        # the card unless the caller or the config asks for the CPU
        self.device = resolve_device(
            device or self.train_cfg.get("device") or "cuda")
        if process_count() > 1:
            make_mesh(MeshConfig.from_dict(self.train_cfg.get("mesh")),
                      device_type=self.device.type)
        self.mesh = get_mesh()
        self.is_main = is_main()
        self.logger = ExperimentLogger()
        self.metrics = LogHelper()
        self.timer = Timer()
        self.total_step_counter = 0

    # ------------------------------------------------------------- state
    @property
    def sharded(self) -> bool:
        """Whether the mesh may split the parameters (fsdp, tensor or pipe
        > 1)."""
        return self.mesh.fsdp * self.mesh.tensor * self.mesh.pipe > 1

    def make_state(self, model: torch.nn.Module) -> TrainState:
        """The state of ``model`` (the full weights, alike on every rank):
        split by the rules under the fsdp, tensor and pipe axes, then the
        EMA and the optimizer over what this rank keeps."""
        if self.sharded:
            shard_params(model, self.mesh)
        ema_dtype = self.train_cfg.get("ema_dtype")
        dt = getattr(torch, ema_dtype) if ema_dtype else None
        ema = {n: p.detach().clone().to(dt or p.dtype)
               for n, p in model.named_parameters()}
        return TrainState(model=model, ema=ema,
                          optimizer=build_optimizer(
                              self.train_cfg, model.named_parameters()))

    # -------------------------------------------------------- train step
    def loss_fn(self, model, batch, generator):
        """-> (loss, {name: detached scalar})"""
        raise NotImplementedError

    def train_step(self, state: TrainState, micro_batches: List,
                   generator: torch.Generator,
                   clip_norm: Optional[float] = None) -> Dict:
        """One optimizer step over the micro-batches; returns the step's
        metrics as device scalars (no host sync).

        Under a torch.profiler capture the step records its phases as
        spans (utils/profiling.py ``span``) of step ``state.step``:
        ``owl.train.step`` around it all, ``owl.train.forward`` around
        each loss, ``owl.train.backward`` around each backward (with
        remat it holds the recomputed forward too) and
        ``owl.train.update`` around what follows the last backward, in
        which ``owl.train.reduce``, ``owl.train.clip`` (when clipping),
        ``owl.train.watch`` (under ``train.watch``),
        ``owl.train.optimizer``, ``owl.train.param_norm`` and
        ``owl.train.ema``."""
        step = state.step
        with span("owl.train.step", step):
            model, opt = state.model, state.optimizer
            accum = len(micro_batches)
            opt.zero_grad(set_to_none=True)
            sums: Dict[str, torch.Tensor] = {}
            for mb in micro_batches:
                with span("owl.train.forward", step):
                    loss, metrics = self.loss_fn(model, mb, generator)
                with span("owl.train.backward", step):
                    (loss / accum).backward()
                for k, v in metrics.items():
                    sums[k] = sums.get(k, 0.0) + v
            with span("owl.train.update", step):
                metrics = {k: v / accum for k, v in sums.items()}
                self.apply_update(state, metrics, clip_norm, step)
        state.step += 1
        return metrics

    @torch.no_grad()
    def apply_update(self, state: TrainState, metrics: Dict,
                     clip_norm: Optional[float], step: int):
        """The step after the backward: the sums over ranks, the clip, the
        watch, the optimizer, the parameters' norm and the EMA; adds its
        metrics to ``metrics``."""
        model, opt = state.model, state.optimizer
        params = [p for p in model.parameters()]
        with span("owl.train.reduce", step):
            self.reduce_across_ranks(params, metrics)
        if clip_norm is not None:
            with span("owl.train.clip", step):
                metrics["grad_norm"] = clip_grad_norm(params, clip_norm)
        watch = self.train_cfg.get("watch")
        if watch:
            with span("owl.train.watch", step):
                metrics.update(self.watch(
                    model.named_parameters(), watch,
                    bins=int(self.train_cfg.get("watch_bins") or 64)))
        with span("owl.train.optimizer", step):
            opt.step()
        with span("owl.train.param_norm", step):
            metrics["param_norm"] = layout_norm(params, params)
        with span("owl.train.ema", step):
            ema_update(state.ema, model.named_parameters(), self.EMA_BETA)
        opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def watch(self, named_params, mode: str, bins: int = 64,
              depth: int = 2) -> Dict[str, torch.Tensor]:
        """utils/telemetry.py ``watch_metrics`` of the whole model, on every
        rank alike. Unsharded, each rank holds the whole model and its
        summed gradients. Under the fsdp, tensor and pipe axes a rank holds
        slices: a group's squares are weighted as ``global_norm`` weights
        them and summed over every rank (a pipe rank adds the groups of the
        other stages' blocks); the histograms take the min and max over
        every rank, and each slice's elements are counted on the one rank
        of its copies whose place on every axis that does not split it is
        0."""
        named = list(named_params)
        if not self.sharded:
            return watch_metrics(named, mode, bins=bins, depth=depth)
        mesh = self.mesh
        coords = mesh_coords_of(mesh)
        world, dev = process_count(), named[0][1].device
        trees = {"params": [p.detach() for _, p in named],
                 "grads": [p.grad if p.grad is not None
                           else torch.zeros_like(p) for _, p in named]}
        keys = self._watch_keys(named, depth)
        slot = {k: i for i, k in enumerate(keys)}
        squares = torch.zeros(2, len(keys), dtype=torch.float32, device=dev)
        counted = []
        for i, (name, p) in enumerate(named):
            spec, stage = spec_of(p), stage_of(p)
            split = {a for a in (spec.axes if spec else ()) if a}
            if stage is not None:
                split.add("pipe")
            share = (spec.n_shards if spec else 1) * (
                mesh.pipe if stage is not None else 1) / world
            j = slot[group_key(name, depth)]
            for row, tree in enumerate(trees.values()):
                squares[row, j] += tree[i].float().pow(2).sum() * share
            counted.append(all(c == 0 for a, c in coords.items()
                               if a not in split))
        dist.all_reduce(squares)
        norms = squares.sqrt()
        out = {}
        for row, what in enumerate(("param_norm", "grad_norm")):
            out.update({f"watch/{what}/{k}": norms[row, slot[k]]
                        for k in keys})
        if mode == "full":
            for name, tree in trees.items():
                lo, hi = value_range(tree)
                dist.all_reduce(lo, op=dist.ReduceOp.MIN)
                dist.all_reduce(hi, op=dist.ReduceOp.MAX)
                mine = [t for t, c in zip(tree, counted) if c]
                counts = (bin_counts(mine, lo, hi, bins) if mine else
                          torch.zeros(bins, dtype=torch.int64, device=dev))
                dist.all_reduce(counts)
                out[f"watch_hist/{name}"] = counts.to(torch.int32)
                out[f"watch_hist/{name}_lo"] = lo
                out[f"watch_hist/{name}_hi"] = hi
        return out

    def _watch_keys(self, named, depth: int) -> List[str]:
        """Every rank's parameter groups, sorted (gathered once)."""
        if getattr(self, "_watch_key_list", None) is None:
            mine = sorted({group_key(n, depth) for n, _ in named})
            every = [None] * process_count()
            dist.all_gather_object(every, mine)
            self._watch_key_list = sorted(set().union(*every))
        return self._watch_key_list

    @torch.no_grad()
    def reduce_across_ranks(self, params, metrics: Dict):
        """Sum the gradients and the metrics over the ranks that hold the
        same elements (every rank of this tensor and pipe index; for an
        fsdp shard, whose gradient the reduce-scatter summed over fsdp
        already, the data x seq ranks of this fsdp, tensor and pipe index)
        and divide by the number of batch ranks, times the seq ranks
        where each holds the whole loss (no sequence parallelism); a no-op
        for one process."""
        if process_count() <= 1:
            return
        mesh = self.mesh
        # without sequence parallelism every seq rank holds the whole loss
        # of its batch, as the JAX package replicates it over seq
        n_batch = mesh.batch_ranks * (
            1 if seq_parallel_active(self.model_cfg) else mesh.seq)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            spec = spec_of(p)
            group = (mesh.shard_replica_group
                     if spec is not None and "fsdp" in spec.axes
                     else mesh.replica_group)
            if group is not None:
                dist.all_reduce(p.grad, group=group)
            p.grad.div_(n_batch)
        for k, v in metrics.items():
            v = torch.as_tensor(v, dtype=torch.float32,
                                device=self.device).clone()
            if mesh.replica_group is not None:
                dist.all_reduce(v, group=mesh.replica_group)
            metrics[k] = v / n_batch

    # ------------------------------------------------------ checkpoints
    def ckpt_path(self, step: int) -> str:
        return os.path.join(self.train_cfg.checkpoint_dir, f"step_{step}.pt")

    def logical_state(self, state: TrainState) -> Optional[Dict]:
        """The checkpoint payload with every sharded tensor gathered to
        its full shape (a collective under the fsdp, tensor and pipe
        axes, on the CPU there; every rank must call it). Under the pipe
        axis every stage's tensors are merged on the first rank of each
        pipe group (``collect_stage_list``), and the other ranks get
        None. The moments are numbered as one process numbers them."""
        named = list(state.model.named_parameters())
        specs = {n: spec_of(p) for n, p in named}
        cpu = "cpu" if self.sharded else None

        def full(t, spec):
            t = gather_tensor(t, spec, self.mesh)
            return t if cpu is None else t.to(cpu)

        params = {n: full(t, specs.get(n))
                  for n, t in state.model.state_dict().items()}
        ema = {n: full(e, specs[n]) for n, e in state.ema.items()}
        opt = _map_opt_state(state.optimizer,
                             lambda t, p: full(t, spec_of(p)))
        if self.mesh.pipe > 1:
            names = _opt_names(state.optimizer, named)
            staged = {n for n, p in named if stage_of(p) is not None}
            parts = collect_stage_list(
                dict(params=params, ema=ema, names=names, staged=staged,
                     opt=_opt_by_name(opt, names)), self.mesh)
            if parts is None:
                return None
            staged = set().union(*(part["staged"] for part in parts))

            def merged(key):
                out = {}
                for part in parts:
                    out.update(part[key])
                order = _merge_stage_orders([list(part[key])
                                             for part in parts], staged)
                return {n: out[n] for n in order}

            params, ema = merged("params"), merged("ema")
            names = {key: _merge_stage_orders(
                [part["names"][key] for part in parts], staged)
                for key in names}
            opt = _opt_from_names([part["opt"] for part in parts], names)
        return {"params": params, "ema_params": ema, "opt_state": opt,
                "step": state.step}

    def save(self, state: TrainState):
        """Write step_N.pt (the full logical state, from rank 0), plus the
        EMA export when output_path is set. Every rank calls it."""
        payload = self.logical_state(state)
        if not self.is_main:
            return
        save_checkpoint(self.ckpt_path(state.step), payload)
        out = self.train_cfg.get("output_path")
        if out:
            save_clean_export(out, payload["ema_params"])

    def load(self, path: str, state: TrainState) -> TrainState:
        """Restore a checkpoint written on any mesh: each full tensor is
        sliced onto this rank's place on the live one."""
        restored = load_checkpoint(path, map_location=self.device)
        coords = mesh_coords_of(self.mesh)
        specs = {n: spec_of(p) for n, p in state.model.named_parameters()}

        def local(t, spec):
            return t if spec is None else spec.shard(t, coords)

        # a pipeline stage takes its own blocks' tensors
        own = state.model.state_dict()
        state.model.load_state_dict(
            {n: local(t, specs.get(n))
             for n, t in restored["params"].items() if n in own},
            strict=True)
        with torch.no_grad():
            for name, e in state.ema.items():
                e.copy_(local(restored["ema_params"][name], specs[name]))
        opt = state.optimizer
        state_dict = restored["opt_state"]
        if self.mesh.pipe > 1:
            # the moments are numbered as one process numbers them; a
            # stage takes its own, renumbered
            live = _opt_names(opt, state.model.named_parameters())
            saved = _saved_opt_names(restored["ema_params"], live,
                                     self.train_cfg)
            state_dict = _opt_from_names(
                [_opt_by_name(state_dict, saved)], live)
        _map_opt_state(opt, lambda t, p: local(t, spec_of(p)),
                       state_dict=state_dict)
        opt.load_state_dict(state_dict)
        state.step = int(restored["step"])
        return state

    # ------------------------------------------------- failure handling
    def install_preemption_handler(self):
        """SIGTERM/SIGINT set a flag; the loop checkpoints and exits at
        the next step boundary."""
        self._preempted = False

        def _handler(signum, frame):
            self._preempted = True

        try:
            self._prev_handlers = {
                signal.SIGTERM: signal.signal(signal.SIGTERM, _handler),
                signal.SIGINT: signal.signal(signal.SIGINT, _handler),
            }
        except ValueError:
            pass  # not on the main thread (e.g. under test runners)

    def restore_preemption_handler(self):
        """Reinstate whatever handled SIGTERM/SIGINT before train()."""
        for sig, prev in getattr(self, "_prev_handlers", {}).items():
            try:
                signal.signal(sig, prev)
            except ValueError:
                pass
        self._prev_handlers = {}

    def should_stop(self) -> bool:
        return getattr(self, "_preempted", False)

    # ----------------------------------------------------------- helpers
    def data_stream(self, data_id: str, batch_size: int, data_kwargs):
        """The batches of ``data_id`` on the trainer's device: the loader
        of this process's data shard (data/__init__.py), started (a
        loader with ``sleep_until_queues_filled`` fills its queues, then
        every rank meets), fed through ``device_prefetch`` with two
        batches in flight. Arrays arrive as loaded, float32 not cast: the
        losses cast, as the JAX package's stacked put does not."""
        loader = get_loader(data_id, batch_size,
                            **dict((data_kwargs or {}).items()))
        if hasattr(loader, "sleep_until_queues_filled"):
            loader.sleep_until_queues_filled()
            barrier()
        return device_prefetch(iter(loader), self.device, size=2)

    def to_device(self, batch):
        """A loader's numpy batch -> tensors on the trainer's device."""
        return [torch.from_numpy(np.asarray(x)).to(self.device)
                for x in batch]

    def log_interval(self) -> int:
        """Steps between host-blocking metric drains."""
        return int(self.train_cfg.get("log_interval") or 10)

    def accum_steps(self) -> int:
        """target_batch_size // batch_size // batch ranks (data x fsdp;
        the tensor and seq ranks of one batch rank share its batch)."""
        return max(1, self.train_cfg.target_batch_size
                   // self.train_cfg.batch_size // self.mesh.batch_ranks)

    def grad_clip_norm(self) -> Optional[float]:
        """clip 10.0 for non-Muon."""
        if (self.train_cfg.opt or "AdamW").lower() == "muon":
            return None
        return 10.0
