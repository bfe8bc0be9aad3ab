"""Shared machinery of the distillation trainers (counterpart of
owl_audio_exps_tpu/trainers/distill_common.py): the frozen teacher, the
student and the critic (initialised as a copy of the student), their
optimizers and the student's EMA, the rollout noising helpers and the
clipped update.

The three are cores of the video model (``GameRFTCore``) with float32
master weights and compute in ``dtype`` (bf16 by default); the teacher
takes ``teacher_cfg``'s model config when one is given. ``teacher_ckpt``
and ``student_ckpt`` are read with ``versatile_load`` (a ``save_checkpoint``
file, or the directory of a ``save_clean_export``), a training wrapper's
``core.`` prefix stripped. Each optimizer step clips the global gradient
norm to 10 and runs AdamW or Adam with optax's arithmetic; the student's
step then moves its EMA with beta 0.99.

The trainers draw their noise from ``self.generator`` (on the trainer's
device, seeded per trainer as the JAX trainers seed their keys, plus the
batch rank); every loss and rollout also takes its draws as an argument,
so that a caller can hand in the JAX trainer's draws. A draw that sets
how many forwards a step runs (the Self-Forcing rollout's Euler steps)
comes from ``self.shared_generator``, seeded alike on every rank, so
that the ranks of a sharded step run the same collectives.

Several processes (``torchrun``; the mesh of ``train.mesh``,
parallel/mesh.py) run the reference's DDP layout at ``{data: n}`` and
any mesh of data, fsdp and tensor: every rank builds the three cores
alike from the seeds (and the checkpoints), then keeps its slices by the
rules of parallel/sharding.py, as the JAX trainer places them
(owl_audio_exps_tpu/trainers/distill_common.py:110-150); the optimizers
and the EMA hold the slices. Each batch rank reads its own shard of the
data (trainers/base.py ``data_stream``) and draws from its own
generator, the tensor ranks of one batch rank alike; the student's and
the critic's gradients and the metrics are summed over the ranks that
hold the same elements and divided by the batch ranks before the clip
(trainers/base.py ``reduce_across_ranks``). Rank 0 alone logs and writes
checkpoints, gathered whole.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional

import torch

from ..models import get_core_cls
from ..muon import AdamW
from ..parallel.sharding import gather_tensor, shard_params, spec_of
from ..utils.checkpoints import (save_checkpoint, save_clean_export,
                                 unwrap_core, versatile_load)
from .base import BaseTrainer, _map_opt_state, clip_grad_norm

CLIP_NORM = 10.0


@dataclasses.dataclass
class DistillState:
    student: torch.nn.Module
    student_ema: Dict[str, torch.Tensor]
    student_opt: AdamW
    critic: torch.nn.Module
    critic_opt: AdamW
    step: int = 0


def zlerp_batched(x: torch.Tensor, t: torch.Tensor,
                  z: torch.Tensor) -> torch.Tensor:
    """Per-frame partial noising in float32: x [b, n, ...] towards the
    draws z by t [b, n]."""
    te = t.reshape(t.shape + (1,) * (x.ndim - 2)).float()
    return x.float() * (1.0 - te) + z * te


def lerp_batched(x: torch.Tensor, z: torch.Tensor, t: torch.Tensor):
    """(x noised towards z by t, the velocity target z - x), float32."""
    xf = x.float()
    return zlerp_batched(xf, t, z), z - xf


def sample_discrete_ts(shape, generator: Optional[torch.Generator], device,
                       values=(1.0, 0.5)) -> torch.Tensor:
    """Per-frame times drawn from the distilled step grid ``values``."""
    idx = torch.randint(len(values), tuple(shape), generator=generator,
                        device=device)
    return torch.tensor(values, dtype=torch.float32, device=device)[idx]


def build_simple_opt(name: Optional[str], kwargs, params) -> AdamW:
    """AdamW or Adam over ``params`` with optax's arithmetic; any other
    name (Muon included) raises ValueError, as in the JAX package."""
    kwargs = dict(kwargs or {})
    lr = kwargs.pop("lr", 1e-4)
    betas = tuple(kwargs.pop("betas", (0.9, 0.999)))
    name = (name or "AdamW").lower()
    if name == "adamw":
        return AdamW(params, lr, betas=betas, eps=kwargs.pop("eps", 1e-8),
                     weight_decay=kwargs.pop("weight_decay", 0.01))
    if name == "adam":
        return AdamW(params, lr, betas=betas, eps=kwargs.pop("eps", 1e-8),
                     weight_decay=0.0)
    raise ValueError(f"Unsupported distill optimizer: {name}")


@torch.no_grad()
def clip_and_update(params, opt, clip_norm: float = CLIP_NORM):
    """Clip the global gradient norm, step the optimizer; returns the norm
    before clipping."""
    gnorm = clip_grad_norm(params, clip_norm)
    opt.step()
    return gnorm


def check_video_model(model_cfg, what: str):
    """The distillation trainers call every core as core(x, t, mouse,
    btn): the video model's. The JAX trainers fail on other models while
    initialising (an AV core takes (x, audio, t, mouse, btn)); the port
    refuses them before any work."""
    model_id = model_cfg.get("model_id")
    if model_id != "game_rft":
        raise ValueError(
            f"{what} model_id {model_id!r}: the distillation trainers are "
            "video-only (they call each core as core(x, t, mouse, btn), the "
            "'game_rft' core's signature; an AV core takes (x, audio, t, "
            "mouse, btn))")


class DistillTrainerBase(BaseTrainer):
    """Teacher (frozen) + student + critic, all cores."""

    EMA_BETA = 0.99
    SEED = 11   # the generator's seed (the JAX trainer's key)

    def __init__(self, cfg, device=None, dtype=torch.bfloat16):
        # distillation forces causal, no CFG dropout
        cfg.model.cfg_prob = 0.0
        cfg.model.causal = True
        check_video_model(cfg.model, "model")
        teacher_path = cfg.train.get("teacher_cfg")
        if teacher_path:
            from ..configs import Config
            self.teacher_cfg = Config.from_yaml(teacher_path).model
        else:
            self.teacher_cfg = cfg.model
        check_video_model(self.teacher_cfg, "teacher_cfg")
        super().__init__(cfg, device)
        self.dtype = dtype
        self.teacher = None
        self._eval_core = None
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.SEED + self.mesh.batch_rank)
        self.shared_generator = torch.Generator(
            device=self.device).manual_seed(self.SEED)

    # ------------------------------------------------------------- state
    def make_core(self, model_cfg, seed: Optional[int]):
        return get_core_cls(model_cfg.model_id)(
            model_cfg, dtype=self.dtype, device=self.device, seed=seed)

    def load_core(self, core, key: str):
        """Load ``train.<key>`` into ``core``; raises ValueError naming
        the checkpoint when its weights do not fit the core."""
        path = self.train_cfg.get(key)
        state = unwrap_core(versatile_load(path, map_location=self.device))
        try:
            core.load_state_dict(state, strict=True)
        except RuntimeError as e:
            raise ValueError(
                f"{key} {path!r} does not fit the {core.config.n_layers}-"
                f"layer core it is loaded into: {e}") from e

    def init_distill_state(self) -> DistillState:
        student = self.make_core(self.model_cfg, seed=0).train()
        teacher = self.make_core(self.teacher_cfg, seed=1)
        if self.train_cfg.get("teacher_ckpt"):
            self.load_core(teacher, "teacher_ckpt")
        self.teacher = teacher.requires_grad_(False)
        if self.train_cfg.get("student_ckpt"):
            self.load_core(student, "student_ckpt")
        critic = copy.deepcopy(student)
        self.init_student(student)
        if self.sharded:
            for core in (student, critic, teacher):
                shard_params(core, self.mesh)
        tc = self.train_cfg
        return DistillState(
            student=student, student_ema=self.ema_of(student),
            student_opt=build_simple_opt(tc.opt, tc.opt_kwargs,
                                         student.parameters()),
            critic=critic,
            critic_opt=build_simple_opt(
                tc.opt, tc.get("d_opt_kwargs") or tc.opt_kwargs,
                critic.parameters()))

    def init_student(self, student):
        """A trainer's own initialisation of the student (after the
        critic's copy, before the cores are sharded)."""

    @staticmethod
    def ema_of(core) -> Dict[str, torch.Tensor]:
        return {n: p.detach().clone() for n, p in core.named_parameters()}

    @torch.no_grad()
    def update_ema(self, state: DistillState):
        beta = self.EMA_BETA
        for name, p in state.student.named_parameters():
            e = state.student_ema[name]
            e.mul_(beta).add_(p * (1.0 - beta))

    def ema_core(self, state: DistillState):
        """A core (built once) holding the student's EMA weights, which
        the eval samples from."""
        if self._eval_core is None:
            self._eval_core = self.make_core(self.model_cfg, seed=None)
            if self.sharded:
                shard_params(self._eval_core, self.mesh)
        with torch.no_grad():
            for name, p in self._eval_core.named_parameters():
                p.copy_(state.student_ema[name])
        return self._eval_core

    def teacher_velocity(self, x, t, mouse, btn, cfg_scale: float):
        """The teacher's float32 velocity, guided at ``cfg_scale`` with
        zeroed controls as the unconditional leg (no gradient)."""
        with torch.no_grad():
            cond = self.teacher(x, t, mouse, btn).float()
            if cfg_scale == 1.0:
                return cond
            uncond = self.teacher(x, t, torch.zeros_like(mouse),
                                  torch.zeros_like(btn)).float()
            return uncond + cfg_scale * (cond - uncond)

    # -------------------------------------------------------------- data
    def scaled_video(self, vid):
        return (vid / self.train_cfg.vae_scale).to(torch.bfloat16)

    def next_micro_batches(self, batches, accum: int) -> List:
        return [next(batches) for _ in range(accum)]

    # --------------------------------------------------------- the steps
    def accumulate(self, core, loss_fn, micro_batches, draws=None):
        """Sum the gradients of ``loss_fn(mb, draws_i) / accum`` over the
        micro-batches into ``core``; returns the mean metrics."""
        accum = len(micro_batches)
        core.zero_grad(set_to_none=True)
        sums: Dict[str, torch.Tensor] = {}
        for i, mb in enumerate(micro_batches):
            loss, metrics = loss_fn(mb, None if draws is None else draws[i])
            (loss / accum).backward()
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v
        metrics = {k: v / accum for k, v in sums.items()}
        self.reduce_across_ranks(list(core.parameters()), metrics)
        return metrics

    def student_update(self, state: DistillState, metrics: Dict):
        """Clip and step the student, move its EMA, count the step."""
        params = list(state.student.parameters())
        metrics["g_norm"] = clip_and_update(params, state.student_opt)
        state.student.zero_grad(set_to_none=True)
        self.update_ema(state)
        state.step += 1
        return metrics

    def save(self, state: DistillState):
        """step_N.pt with the student, its EMA and optimizer, the critic
        and its optimizer, each gathered whole (a collective under the
        fsdp and tensor axes: every rank calls it, rank 0 writes); plus
        the EMA export when output_path is set."""
        cpu = "cpu" if self.sharded else None
        specs = {n: spec_of(p) for core in (state.student, state.critic)
                 for n, p in core.named_parameters()}

        def full(t, spec):
            t = gather_tensor(t, spec, self.mesh)
            return t if cpu is None else t.to(cpu)

        def whole(core):
            named = dict(core.named_parameters())
            return {n: full(t, spec_of(named[n]) if n in named else None)
                    for n, t in core.state_dict().items()}

        payload = {
            "params": whole(state.student),
            "ema_params": {n: full(e, specs[n])
                           for n, e in state.student_ema.items()},
            "opt_state": _map_opt_state(state.student_opt,
                                        lambda t, p: full(t, spec_of(p))),
            "critic": whole(state.critic),
            "critic_opt": _map_opt_state(state.critic_opt,
                                         lambda t, p: full(t, spec_of(p))),
            "step": state.step,
        }
        if not self.is_main:
            return
        save_checkpoint(self.ckpt_path(state.step), payload)
        out = self.train_cfg.get("output_path")
        if out:
            save_clean_export(out, state.student_ema)

    def total_steps(self, max_steps: Optional[int]) -> int:
        return max_steps if max_steps is not None else \
            self.train_cfg.get("max_steps") or int(1e12)
