"""ODE / prune distillation trainer, video (counterpart of
owl_audio_exps_tpu/trainers/ode_distill.py).

1. When the student is shallower than the teacher and ``teacher_ckpt`` is
   set, the student starts from a layer-subsampled copy of the teacher
   that keeps its first and last blocks (``transfer_pruned_params``).
2. The teacher runs an SD3-Euler trajectory of ``ode_steps`` steps (8 by
   default) from noise, guided at CFG 1.3 with zeroed controls as the
   unconditional leg, under no gradient; the student regresses the
   teacher's velocity at each state, each step's squared error weighted
   by a random ``keep`` mask (a ``subsample`` fraction, step 0 always
   kept) normalised to sum 1.

The JAX package vmaps the student over the steps; the port stacks the
steps on the batch axis (step-major), one forward of ode_steps x b
samples, with the same loss and gradients.
"""

from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..sampling.schedulers import get_sd3_euler
from ..utils.logging import DeferredMetrics
from .distill_common import DistillState, DistillTrainerBase


def prune_layer_indices(n_teacher: int, n_student: int) -> List[int]:
    """Evenly subsample teacher layers, always keeping first and last."""
    if not 2 <= n_student <= n_teacher:
        raise ValueError(f"cannot prune {n_teacher} layers to {n_student}")
    idx = np.round(np.linspace(0, n_teacher - 1, n_student)).astype(int)
    idx[0], idx[-1] = 0, n_teacher - 1
    return list(dict.fromkeys(idx.tolist()))


_BLOCK = re.compile(r"^transformer\.blocks\.(\d+)\.(.*)$")


def transfer_pruned_params(teacher: Dict[str, torch.Tensor], n_teacher: int,
                           n_student: int) -> Dict[str, torch.Tensor]:
    """Student state dict from a teacher's: ``transformer.blocks.i``
    copies teacher block ``prune_layer_indices(...)[i]``; every other
    weight copies directly."""
    idx = prune_layer_indices(n_teacher, n_student)
    source = {t_i: s_i for s_i, t_i in enumerate(idx)}
    out = {}
    for name, value in teacher.items():
        m = _BLOCK.match(name)
        if m is None:
            out[name] = value.clone()
        elif int(m.group(1)) in source:
            out[f"transformer.blocks.{source[int(m.group(1))]}."
                f"{m.group(2)}"] = value.clone()
    return out


class ODEDraws(NamedTuple):
    x: torch.Tensor      # float32 initial noise of the latents' shape
    keep: torch.Tensor   # [ode_steps] bool: the steps the student regresses


class DistillODETrainer(DistillTrainerBase):
    """Student regresses teacher CFG velocities along Euler trajectories."""

    CFG_SCALE = 1.3
    SEED = 21

    def ode_draws(self, vid) -> ODEDraws:
        gen, dev = self.generator, vid.device
        n_steps = self.train_cfg.get("ode_steps", 8)
        subsample = self.train_cfg.get("subsample", 0.25)
        x = torch.randn(vid.shape, generator=gen, device=dev)
        keep = torch.rand(n_steps, generator=gen, device=dev) < subsample
        return ODEDraws(x, keep)

    def ode_loss(self, student, batch, draws: Optional[ODEDraws] = None):
        vid, mouse, btn = batch[:3]
        vid = self.scaled_video(vid)
        b, n = vid.shape[:2]
        n_steps = self.train_cfg.get("ode_steps", 8)
        if draws is None:
            draws = self.ode_draws(vid)

        # the teacher's trajectory: (x_t, t, v) at each step, no gradient
        x = draws.x.float()
        t = torch.ones(b, n, dtype=torch.float32, device=vid.device)
        xs, ts, vs = [], [], []
        for dt in get_sd3_euler(n_steps):
            v = self.teacher_velocity(x.to(vid.dtype), t.to(vid.dtype),
                                      mouse, btn, self.CFG_SCALE)
            xs.append(x)
            ts.append(t)
            vs.append(v)
            x, t = x - float(dt) * v, t - float(dt)

        keep = draws.keep.clone()
        keep[0] = True   # always keep at least one step
        w = keep.float() / keep.float().sum()

        # every step's state stacked on the batch axis, step-major
        pred = student(torch.cat(xs).to(vid.dtype),
                       torch.cat(ts).to(vid.dtype),
                       mouse.repeat(n_steps, 1, 1), btn.repeat(n_steps, 1, 1))
        errs = torch.square(pred.float() - torch.cat(vs)).reshape(
            n_steps, -1).mean(dim=1)
        loss = torch.sum(errs * w)
        return loss, {"ode_loss": loss.detach()}

    def init_student(self, student):
        """The layer-pruned init when the student is shallower than the
        teacher (before the cores are sharded; the EMA and the optimizer
        are built over it)."""
        t_layers = self.teacher_cfg.n_layers
        s_layers = self.model_cfg.n_layers
        if s_layers < t_layers and self.train_cfg.get("teacher_ckpt"):
            student.load_state_dict(transfer_pruned_params(
                self.teacher.state_dict(), t_layers, s_layers), strict=True)

    def step(self, state: DistillState, micro_batches, draws=None):
        """One student update (and EMA move) over the micro-batches."""
        metrics = self.accumulate(
            state.student, lambda mb, d: self.ode_loss(state.student, mb, d),
            micro_batches, draws)
        return self.student_update(state, metrics)

    def train(self, max_steps: Optional[int] = None) -> DistillState:
        accum = self.accum_steps()
        state = self.init_distill_state()
        batches = self.data_stream(self.train_cfg.data_id,
                                   self.train_cfg.batch_size,
                                   self.train_cfg.data_kwargs)
        pending = DeferredMetrics()
        log_interval = self.log_interval()
        total = self.total_steps(max_steps)
        self.timer.reset()

        while self.total_step_counter < total:
            m = self.step(state, self.next_micro_batches(batches, accum))
            pending.append(self.total_step_counter + 1, m)
            self.total_step_counter += 1
            do_save = \
                self.total_step_counter % self.train_cfg.save_interval == 0
            if not (self.total_step_counter % log_interval == 0 or do_save
                    or self.total_step_counter >= total):
                continue
            for _, mm in pending.drain():
                self.metrics.log_dict(mm)
            log = self.metrics.pop()
            log["time"] = self.timer.hit()
            if self.is_main:
                self.logger.log(log, step=self.total_step_counter)
            if do_save:
                self.save(state)
            self.timer.reset()
        return state
