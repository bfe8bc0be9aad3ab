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
before the update (utils/telemetry.py). Parameters and optimizer state are
updated in place.

Several processes (one per device, under ``torchrun``; parallel/dist.py)
form the mesh of ``train.mesh`` (parallel/mesh.py): data ranks draw
distinct batches, the seq ranks of one data rank the same batch, of
which each computes its slice of the frames (context parallelism). The
gradients and metrics are summed over every rank and divided by the
number of data ranks before the clip and the optimizer, so every rank
takes the same step: seq ranks hold shares of one loss, data ranks
average theirs. Rank 0 alone logs and saves; every rank resumes.
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
from ..muon import AdamW, init_muon
from ..parallel.dist import barrier, is_main, process_count
from ..parallel.mesh import MeshConfig, get_mesh, make_mesh
from ..schedulers import get_scheduler_cls
from ..utils.checkpoints import (load_checkpoint, save_checkpoint,
                                 save_clean_export)
from ..utils.device import resolve_device
from ..utils.logging import ExperimentLogger, LogHelper, Timer
from ..utils.telemetry import watch_metrics


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


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


@torch.no_grad()
def clip_grad_norm(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients by min(1, max_norm / (norm + 1e-6)), as the
    JAX package's step does; returns the norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    gnorm = global_norm(grads)
    scale = torch.clamp(max_norm / (gnorm + 1e-6), max=1.0)
    for g in grads:
        g.mul_(scale)
    return gnorm


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
    def make_state(self, model: torch.nn.Module) -> TrainState:
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
        metrics as device scalars (no host sync)."""
        model, opt = state.model, state.optimizer
        beta = self.EMA_BETA
        accum = len(micro_batches)
        opt.zero_grad(set_to_none=True)
        sums: Dict[str, torch.Tensor] = {}
        for mb in micro_batches:
            loss, metrics = self.loss_fn(model, mb, generator)
            (loss / accum).backward()
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v
        metrics = {k: v / accum for k, v in sums.items()}
        params = [p for p in model.parameters()]
        self.reduce_across_ranks(params, metrics)
        with torch.no_grad():
            if clip_norm is not None:
                metrics["grad_norm"] = clip_grad_norm(params, clip_norm)
            watch = self.train_cfg.get("watch")
            if watch:
                metrics.update(watch_metrics(
                    model.named_parameters(), watch,
                    bins=int(self.train_cfg.get("watch_bins") or 64)))
            opt.step()
            metrics["param_norm"] = global_norm(params)
            for name, p in model.named_parameters():
                e = state.ema[name]
                e.mul_(beta).add_(p.to(e.dtype) * (1.0 - beta))
        opt.zero_grad(set_to_none=True)
        state.step += 1
        return metrics

    @torch.no_grad()
    def reduce_across_ranks(self, params, metrics: Dict):
        """Sum the gradients and the metrics over every rank and divide
        by the number of data ranks (a no-op for one process)."""
        if process_count() <= 1:
            return
        n_data = self.mesh.data
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            dist.all_reduce(p.grad)
            p.grad.div_(n_data)
        for k, v in metrics.items():
            v = torch.as_tensor(v, dtype=torch.float32,
                                device=self.device).clone()
            dist.all_reduce(v)
            metrics[k] = v / n_data

    # ------------------------------------------------------ checkpoints
    def ckpt_path(self, step: int) -> str:
        return os.path.join(self.train_cfg.checkpoint_dir, f"step_{step}.pt")

    def save(self, state: TrainState):
        """Write step_N.pt, plus the EMA export when output_path is set."""
        payload = {
            "params": state.model.state_dict(),
            "ema_params": state.ema,
            "opt_state": state.optimizer.state_dict(),
            "step": state.step,
        }
        save_checkpoint(self.ckpt_path(state.step), payload)
        out = self.train_cfg.get("output_path")
        if out:
            save_clean_export(out, state.ema)

    def load(self, path: str, state: TrainState) -> TrainState:
        restored = load_checkpoint(path, map_location=self.device)
        state.model.load_state_dict(restored["params"], strict=True)
        with torch.no_grad():
            for name, e in state.ema.items():
                e.copy_(restored["ema_params"][name])
        state.optimizer.load_state_dict(restored["opt_state"])
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
        """target_batch_size // batch_size // data ranks (the seq ranks
        of one data rank share its batch)."""
        return max(1, self.train_cfg.target_batch_size
                   // self.train_cfg.batch_size // self.mesh.data)

    def grad_clip_norm(self) -> Optional[float]:
        """clip 10.0 for non-Muon."""
        if (self.train_cfg.opt or "AdamW").lower() == "muon":
            return None
        return 10.0
