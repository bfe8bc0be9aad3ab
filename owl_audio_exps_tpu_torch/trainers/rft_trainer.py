"""Rectified-flow trainers (counterpart of
owl_audio_exps_tpu/trainers/rft_trainer.py ``RFTFamilyTrainer``,
``RFTTrainer``, ``AVRFTTrainer``, ``MixedAVRFTTrainer`` and
``AudioRFTTrainer``).

The shared loop: epoch-free iteration over the loader, gradient
accumulation, the optimizer step and EMA of trainers/base.py, metrics
drained at the logging cadence (the only host sync of the loop), saves
every ``save_interval`` steps, eval sampling every ``sample_interval``
steps when the trainer's eval has what it reads (an eval loader, or for
the audio trainer only the sampler): the eval samples from the EMA
weights, the video trainer's with the cached video samplers, the AV
trainers' with the window samplers. The noise comes from one
``torch.Generator`` on the device, seeded 1234 plus the data rank, so the
seq ranks of one data rank draw alike. Under several processes every
rank starts from rank 0's initial parameters, loads the batches of its
data rank, and only rank 0 logs and saves (trainers/base.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data import get_loader
from ..models import get_model_cls
from ..parallel.dist import broadcast_from_main
from ..utils.logging import DeferredMetrics
from ..utils.mfu import MFUProfiler
from .base import BaseTrainer, TrainState


class RFTFamilyTrainer(BaseTrainer):
    """Common loop for the flow-matching trainers."""

    model_id: str = None
    # whether eval_step samples from an eval loader (sample_data_id); the
    # sampler is built only when what the eval reads is configured
    eval_reads_loader: bool = True

    def __init__(self, cfg, device=None):
        super().__init__(cfg, device)
        self.model_id = self.model_cfg.model_id or self.model_id
        self._eval_core = None

    # ---- subclass hooks -------------------------------------------------
    def eval_step(self, state: TrainState, sample_loader, sampler):
        return {}

    def ema_core(self, state: TrainState):
        """The model's core (built once) holding the EMA weights, which
        the eval samples from."""
        from ..models import get_core_cls
        if self._eval_core is None:
            self._eval_core = get_core_cls(self.model_id)(
                self.model_cfg, dtype=torch.bfloat16, device=self.device,
                seed=None)
        with torch.no_grad():
            for name, p in self._eval_core.named_parameters():
                p.copy_(state.ema["core." + name])
        return self._eval_core

    def eval_generator(self, seed: int = 0) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    # ---- shared loop ----------------------------------------------------
    def init_state(self, seed: int = 0) -> TrainState:
        model = get_model_cls(self.model_id)(
            self.model_cfg, dtype=torch.bfloat16, device=self.device,
            seed=seed)
        broadcast_from_main(model)
        return self.make_state(model.train())

    def train(self, max_steps: Optional[int] = None) -> TrainState:
        accum = self.accum_steps()
        state = self.init_state()
        if self.train_cfg.resume_ckpt:
            state = self.load(self.train_cfg.resume_ckpt, state)
            self.total_step_counter = state.step

        loader = get_loader(self.train_cfg.data_id, self.train_cfg.batch_size,
                            **dict((self.train_cfg.data_kwargs or {}).items(),
                                   process_index=self.mesh.data_index))
        sampler = sample_loader = None
        has_loader = bool(self.train_cfg.get("sample_data_id"))
        if self.train_cfg.sampler_id and (has_loader
                                          or not self.eval_reads_loader):
            # an eval that reads a loader without one returns {} and never
            # calls the sampler, so it is only built when it is used
            from ..sampling import get_sampler_cls
            skw = dict((self.train_cfg.sampler_kwargs or {}).items())
            sampler = get_sampler_cls(self.train_cfg.sampler_id)(**skw)
        if sampler is not None and has_loader:
            sample_loader = iter(get_loader(
                self.train_cfg.sample_data_id, self.train_cfg.n_samples,
                **dict((self.train_cfg.get("sample_data_kwargs")
                        or {}).items())))

        seq_tokens = self._seq_tokens()
        profiler = MFUProfiler(
            self.model_cfg,
            batch_tokens=accum * self.train_cfg.batch_size * seq_tokens,
            seq_len=seq_tokens)
        generator = torch.Generator(device=self.device).manual_seed(
            1234 + self.mesh.data_index)
        self.timer.reset()
        self.install_preemption_handler()
        try:
            return self._train_loop(state, max_steps, accum, loader, sampler,
                                    sample_loader, profiler, generator)
        finally:
            self.restore_preemption_handler()

    def _train_loop(self, state, max_steps, accum, loader, sampler,
                    sample_loader, profiler, generator):
        total = max_steps if max_steps is not None else \
            self.train_cfg.get("max_steps") or int(1e12)
        data_iter = iter(loader)
        pending = DeferredMetrics()
        log_interval = self.log_interval()
        clip = self.grad_clip_norm()
        profiler.start()

        while self.total_step_counter < total:
            if self.should_stop():
                for _, m in pending.drain():
                    self.metrics.log_dict(m)
                if self.is_main:
                    self.save(state)
                break
            micro = [self.to_device(next(data_iter)) for _ in range(accum)]
            metrics = self.train_step(state, micro, generator, clip_norm=clip)
            pending.append(self.total_step_counter + 1, metrics)
            self.total_step_counter += 1

            do_sample = sampler is not None and \
                self.total_step_counter % self.train_cfg.sample_interval == 0
            do_save = \
                self.total_step_counter % self.train_cfg.save_interval == 0
            boundary = (self.total_step_counter % log_interval == 0
                        or do_sample or do_save
                        or self.total_step_counter >= total)
            if not boundary:
                continue

            # ---- the only host sync in the loop
            drained = pending.drain()
            for _, m in drained:
                self.metrics.log_dict(m)
            profiler.stop(n_steps=len(drained))
            log = self.metrics.pop()
            log["time"] = self.timer.hit() / max(1, len(drained))
            log.update(profiler.report())
            if do_sample:
                log.update(self.eval_step(state, sample_loader, sampler))
            if self.is_main:
                self.logger.log(log, step=self.total_step_counter)
                if do_save:
                    self.save(state)
            # eval/save time is excluded from the next window's step timing
            self.timer.reset()
            profiler.start()
        return state

    def _seq_tokens(self) -> int:
        """Tokens per sample for FLOP accounting."""
        n = (self.train_cfg.data_kwargs or {}).get(
            "window_length", self.model_cfg.n_frames)
        return n * self.model_cfg.tokens_per_frame


class RFTTrainer(RFTFamilyTrainer):
    """Video RFT from latents. Batch: [vid, mouse, btn] or
    [vid, mouse, btn, doc_id]."""

    model_id = "game_rft"

    def loss_fn(self, model, batch, generator):
        vid, mouse, btn = batch[0], batch[1], batch[2]
        doc_id = batch[3] if len(batch) > 3 else None
        vid = (vid / self.train_cfg.vae_scale).to(torch.bfloat16)
        loss = model(vid, mouse, btn, doc_id, generator=generator)
        return loss, {"diffusion_loss": loss.detach()}

    def eval_step(self, state, sample_loader, sampler):
        """Sample from the EMA core with the configured sampler (the
        cached video samplers), the first half of an eval clip (at least
        one frame) as context; returns the latents' std and, with
        ``eval_sample_dir``, saves them as samples_<step>.npy."""
        if sample_loader is None:
            return {}
        vid, mouse, btn = self.to_device(next(sample_loader)[:3])
        vid = (vid / self.train_cfg.vae_scale).to(torch.bfloat16)
        ctx_len = max(1, vid.shape[1] // 2)
        latents = sampler(self.ema_core(state), vid[:, :ctx_len], mouse,
                          btn, generator=self.eval_generator())
        out = {"eval/latent_std": latents.float().std(correction=0).item()}
        sdir = self.train_cfg.get("eval_sample_dir")
        if sdir and self.is_main:
            import os
            os.makedirs(sdir, exist_ok=True)
            np.save(os.path.join(
                sdir, f"samples_{self.total_step_counter}.npy"),
                latents.float().cpu().numpy())
        return out


class AVRFTTrainer(RFTFamilyTrainer):
    """Joint AV RFT. Batch: [vid, audio, mouse, btn]."""

    model_id = "game_rft_audio"

    def scaled_latents(self, vid, audio):
        """Video over ``vae_scale`` and audio over ``audio_vae_scale``
        (``vae_scale`` where unset), in bf16."""
        tc = self.train_cfg
        audio_scale = tc.get("audio_vae_scale", tc.vae_scale)
        return ((vid / tc.vae_scale).to(torch.bfloat16),
                (audio / audio_scale).to(torch.bfloat16))

    def loss_fn(self, model, batch, generator):
        vid, audio, mouse, btn = batch[:4]
        vid, audio = self.scaled_latents(vid, audio)
        loss, v_loss, a_loss = model(vid, audio, mouse, btn,
                                     generator=generator)
        return loss, {"diffusion_loss": loss.detach(),
                      "video_loss": v_loss.detach(),
                      "audio_loss": a_loss.detach()}

    def eval_step(self, state, sample_loader, sampler):
        """Sample an eval clip from the EMA core with the configured
        window sampler; returns the video and audio latents' stds."""
        if sample_loader is None:
            return {}
        vid, audio, mouse, btn = self.to_device(next(sample_loader)[:4])
        vid = (vid / self.train_cfg.vae_scale).to(torch.bfloat16)
        _, _, xl, al, em, eb = sampler(
            self.ema_core(state), vid, audio.to(torch.bfloat16), mouse, btn,
            generator=self.eval_generator())
        self._export_media(xl, al, em, eb)
        return {"eval/video_latent_std": xl.float().std(correction=0).item(),
                "eval/audio_latent_std": al.float().std(correction=0).item()}

    def _export_media(self, video_latents, audio_latents, mouse, btn):
        """Decoded eval media, when ``eval_media_dir`` is set: they need
        the VAE bridge, which is not ported yet."""
        if self.train_cfg.get("eval_media_dir") and self.is_main:
            raise NotImplementedError(
                "eval_media_dir: exporting decoded eval media needs the VAE "
                "bridge, which is not ported yet (ROADMAP.md Queue 1 item 6)")


class MixedAVRFTTrainer(AVRFTTrainer):
    """Joint AV RFT on mixed labelled and unlabelled controls. Batch:
    [vid, audio, mouse, btn, has_controls]; logs the unlabelled
    proportion."""

    def loss_fn(self, model, batch, generator):
        vid, audio, mouse, btn, has_controls = batch[:5]
        vid, audio = self.scaled_latents(vid, audio)
        loss, v_loss, a_loss = model(vid, audio, mouse, btn,
                                     has_controls=has_controls.bool(),
                                     generator=generator)
        return loss, {"diffusion_loss": loss.detach(),
                      "video_loss": v_loss.detach(),
                      "audio_loss": a_loss.detach(),
                      "unlabelled_proportion":
                          1.0 - has_controls.float().mean()}


# the VAE paths of the audio trainer (ROADMAP.md Queue 1 item 6)
_VAE_KEYS = ("vae_ckpt_path", "vae_cfg_path", "eval_media_dir")


class AudioRFTTrainer(RFTFamilyTrainer):
    """Unconditional audio RFT on pre-encoded latents. Batch: [latents
    [b, n, c]]. The JAX trainer can also encode raw waveforms through a
    frozen VAE and export decoded eval clips; the port has no VAE yet, so
    ``vae_ckpt_path``, ``vae_cfg_path`` and ``eval_media_dir`` raise."""

    model_id = "audio_rft"
    eval_reads_loader = False

    def __init__(self, cfg, device=None):
        for key in _VAE_KEYS:
            if cfg.train.get(key):
                raise NotImplementedError(
                    f"{key}: the audio VAE (encoding waveforms, decoding "
                    "eval clips) is not ported yet (ROADMAP.md Queue 1 "
                    "item 6)")
        super().__init__(cfg, device)

    def loss_fn(self, model, batch, generator):
        loss = model(batch[0].to(torch.bfloat16), generator=generator)
        return loss, {"diffusion_loss": loss.detach()}

    def eval_step(self, state, sample_loader, sampler):
        """Sample from the EMA weights with the configured sampler;
        returns the std of the latents."""
        c = self.model_cfg
        b = min(self.train_cfg.n_samples, 4)
        gen = self.eval_generator(7)
        ctx = torch.randn(b, c.sample_size // 2, c.channels, generator=gen,
                          device=self.device).to(torch.bfloat16)
        latents = sampler(self.ema_core(state), ctx,
                          generator=gen.manual_seed(8))
        return {"eval/audio_latent_std":
                latents.float().std(correction=0).item()}
