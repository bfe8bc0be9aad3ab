"""CausVid DMD distillation trainer, video (counterpart of
owl_audio_exps_tpu/trainers/causvid.py).

Alternating optimization: ``update_ratio`` critic steps (a flow-matching
loss on the student's rollouts) per student step (distribution matching
against the teacher guided at CFG 1.5, plus ``regression_weight`` times a
regression onto the clean latents). A rollout re-noises a random quarter
of the frames (the rest to ``NOISE_PREV``) at the distilled step grid
{1.0, 0.5} and takes the student's one-call x0 prediction there.

Draws: ``RolloutDraws`` (the generated-frame mask, the grid times, the
noise) inside ``LossDraws`` (the loss's sigmoid-normal times and noise),
drawn from ``self.generator`` unless the caller hands them in.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..utils.logging import DeferredMetrics
from .distill_common import (DistillState, DistillTrainerBase,
                             clip_and_update, lerp_batched,
                             sample_discrete_ts, zlerp_batched)


class RolloutDraws(NamedTuple):
    gen_mask: torch.Tensor   # [b, n] bool: the frames the student generates
    ts: torch.Tensor         # [b, n] float32 step-grid times
    z: torch.Tensor          # float32 noise of the latents' shape


class LossDraws(NamedTuple):
    rollout: Any             # the trainer's rollout draws
    ts: torch.Tensor         # [b, n] float32 sigmoid-normal times
    z: torch.Tensor          # float32 noise of the latents' shape


def _frames(mask: torch.Tensor) -> torch.Tensor:
    """[b, n] -> [b, n, 1, 1, 1] float32."""
    return mask[:, :, None, None, None].float()


class CausVidTrainer(DistillTrainerBase):
    GEN_MASK_P = 0.25
    NOISE_PREV = 0.2
    TEACHER_CFG_SCALE = 1.5

    # ------------------------------------------------------------ draws
    def rollout_draws(self, vid, mouse) -> RolloutDraws:
        b, n = vid.shape[:2]
        gen, dev = self.generator, vid.device
        return RolloutDraws(
            gen_mask=torch.rand(b, n, generator=gen, device=dev)
            < self.GEN_MASK_P,
            ts=sample_discrete_ts((b, n), gen, dev),
            z=torch.randn(vid.shape, generator=gen, device=dev))

    def loss_draws(self, vid, mouse) -> LossDraws:
        b, n = vid.shape[:2]
        gen, dev = self.generator, vid.device
        rollout = self.rollout_draws(vid, mouse)
        ts = torch.sigmoid(torch.randn(b, n, generator=gen, device=dev))
        return LossDraws(rollout, ts,
                         torch.randn(vid.shape, generator=gen, device=dev))

    # ---------------------------------------------------------- rollout
    def get_rollouts(self, student, vid, mouse, btn, with_grad: bool,
                     draws: Optional[RolloutDraws] = None):
        """One-call rollout -> (rollout float32, gen_mask, mouse, btn,
        regression target), the contract SelfForceTrainer shares."""
        if draws is None:
            draws = self.rollout_draws(vid, mouse)
        ts_full = torch.where(draws.gen_mask, draws.ts.float(),
                              self.NOISE_PREV)
        noisy = zlerp_batched(vid, ts_full, draws.z).to(vid.dtype)
        with torch.set_grad_enabled(with_grad and torch.is_grad_enabled()):
            v_pred = student(noisy, ts_full.to(vid.dtype), mouse, btn)
        te = ts_full[:, :, None, None, None]
        rollout = torch.where(draws.gen_mask[:, :, None, None, None],
                              noisy.float() - v_pred.float() * te,
                              vid.float())
        return rollout, draws.gen_mask, mouse, btn, vid.float()

    # ----------------------------------------------------------- losses
    def critic_loss(self, critic, student, batch,
                    draws: Optional[LossDraws] = None):
        """Flow-matching loss of the critic on the student's rollouts."""
        vid, mouse, btn = batch[:3]
        vid = self.scaled_video(vid)
        if draws is None:
            draws = self.loss_draws(vid, mouse)
        with torch.no_grad():
            rollout, gen_mask, mouse, btn, _ = self.get_rollouts(
                student, vid, mouse, btn, False, draws.rollout)
        noisy, target = lerp_batched(rollout, draws.z, draws.ts)
        pred = critic(noisy.to(vid.dtype), draws.ts.to(vid.dtype), mouse,
                      btn)
        gm = _frames(gen_mask)
        loss = torch.mean(torch.square(pred.float() * gm - target * gm))
        return loss, {"critic_loss": loss.detach()}

    def dmd_loss(self, student, critic, batch,
                 draws: Optional[LossDraws] = None):
        """Distribution matching (the critic's and the guided teacher's
        x0 difference, per-sample normalised, as a detached target) plus
        the weighted regression."""
        vid, mouse, btn = batch[:3]
        vid = self.scaled_video(vid)
        if draws is None:
            draws = self.loss_draws(vid, mouse)
        rollout, gen_mask, mouse, btn, reg_target = self.get_rollouts(
            student, vid, mouse, btn, True, draws.rollout)

        ts = draws.ts.float()
        te = ts[:, :, None, None, None]
        noisy_f32, _ = lerp_batched(rollout.detach(), draws.z, ts)
        noisy, ts_m = noisy_f32.to(vid.dtype), ts.to(vid.dtype)
        v_teacher = self.teacher_velocity(noisy, ts_m, mouse, btn,
                                          self.TEACHER_CFG_SCALE)
        with torch.no_grad():
            v_critic = critic(noisy, ts_m, mouse, btn).float()

        mu_teacher = noisy_f32 - te * v_teacher
        mu_critic = noisy_f32 - te * v_critic
        normalizer = torch.mean(torch.abs(rollout.detach() - mu_teacher),
                                dim=(1, 2, 3, 4), keepdim=True)
        grad = (mu_critic - mu_teacher) / (normalizer + 1e-8)
        grad = torch.nan_to_num(grad, nan=0.0)
        target = (rollout - grad).detach()

        gm = _frames(gen_mask)
        dmd = 0.5 * torch.mean(torch.square(rollout * gm - target * gm))
        regression = torch.mean(torch.square(rollout * gm - reg_target * gm))
        w = self.train_cfg.get("regression_weight", 0.0) or 0.0
        return dmd + w * regression, {"dmd_loss": dmd.detach(),
                                      "regression_loss": regression.detach()}

    # ------------------------------------------------------------ steps
    def critic_step(self, state: DistillState, micro_batches, draws=None):
        """One critic update over the micro-batches (``draws``: one
        ``LossDraws`` each, or None)."""
        metrics = self.accumulate(
            state.critic, lambda mb, d: self.critic_loss(
                state.critic, state.student, mb, d), micro_batches, draws)
        metrics["critic_grad_norm"] = clip_and_update(
            list(state.critic.parameters()), state.critic_opt)
        state.critic.zero_grad(set_to_none=True)
        return metrics

    def student_step(self, state: DistillState, micro_batches, draws=None):
        """One student update (and EMA move) over the micro-batches."""
        metrics = self.accumulate(
            state.student, lambda mb, d: self.dmd_loss(
                state.student, state.critic, mb, d), micro_batches, draws)
        return self.student_update(state, metrics)

    # ------------------------------------------------------------- loop
    def eval_step(self, state: DistillState):
        """Sample with the student's EMA through the configured sampler:
        up to 8 seeded context frames, zero controls; returns the latents'
        std and, with ``eval_sample_dir``, saves them."""
        if not self.train_cfg.sampler_id:
            return {}
        from ..sampling import get_sampler_cls
        skw = dict((self.train_cfg.sampler_kwargs or {}).items())
        sampler = get_sampler_cls(self.train_cfg.sampler_id)(**skw)
        c = self.model_cfg
        n_ctx = min(8, self.train_cfg.get("min_rollout_frames", 8))
        total = n_ctx + sampler.num_frames
        gen = torch.Generator(device=self.device).manual_seed(7)
        ctx = torch.randn(1, n_ctx, c.channels, c.sample_size, c.sample_size,
                          generator=gen, device=self.device
                          ).to(torch.bfloat16)
        kw = dict(dtype=torch.bfloat16, device=self.device)
        mouse = torch.zeros(1, total, c.get("n_mouse_axes", 2), **kw)
        btn = torch.zeros(1, total, c.n_buttons, **kw)
        latents = sampler(self.ema_core(state), ctx, mouse, btn,
                          generator=gen.manual_seed(8))
        out = {"eval/latent_std": latents.float().std(correction=0).item()}
        sdir = self.train_cfg.get("eval_sample_dir")
        if sdir and self.is_main:
            import os
            os.makedirs(sdir, exist_ok=True)
            np.save(os.path.join(
                sdir, f"distill_samples_{self.total_step_counter}.npy"),
                latents.float().cpu().numpy())
        return out

    def train(self, max_steps: Optional[int] = None) -> DistillState:
        accum = self.accum_steps()
        state = self.init_distill_state()
        update_ratio = self.train_cfg.get("update_ratio", 5)
        batches = self.data_stream(self.train_cfg.data_id,
                                   self.train_cfg.batch_size,
                                   self.train_cfg.data_kwargs)
        pending = DeferredMetrics()
        log_interval = self.log_interval()
        total = self.total_steps(max_steps)
        self.timer.reset()

        while self.total_step_counter < total:
            for _ in range(update_ratio):
                m = self.critic_step(state,
                                     self.next_micro_batches(batches, accum))
                pending.append(self.total_step_counter, m)
            m = self.student_step(state,
                                  self.next_micro_batches(batches, accum))
            pending.append(self.total_step_counter + 1, m)

            self.total_step_counter += 1
            do_sample = \
                self.total_step_counter % self.train_cfg.sample_interval == 0
            do_save = \
                self.total_step_counter % self.train_cfg.save_interval == 0
            if not (self.total_step_counter % log_interval == 0 or do_sample
                    or do_save or self.total_step_counter >= total):
                continue

            for _, mm in pending.drain():
                self.metrics.log_dict(mm)
            log = self.metrics.pop()
            log["time"] = self.timer.hit()
            if do_sample:
                log.update(self.eval_step(state))
            if self.is_main:
                self.logger.log(log, step=self.total_step_counter)
            if do_save:
                self.save(state)
            self.timer.reset()
        return state
