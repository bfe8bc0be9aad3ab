"""Rectified-flow trainers (counterpart of
owl_audio_exps_tpu/trainers/rft_trainer.py ``RFTFamilyTrainer``,
``RFTTrainer``, ``AVRFTTrainer``, ``MixedAVRFTTrainer`` and
``AudioRFTTrainer``).

The shared loop: epoch-free iteration over the loader's batches, which
the prefetcher moves to the device ahead of the step (trainers/base.py
``data_stream``), gradient accumulation, the optimizer step and EMA of
trainers/base.py, metrics drained at the logging cadence (the only host
sync of the loop), saves every ``save_interval`` steps, eval sampling
every ``sample_interval`` steps when the trainer's eval has what it
reads (an eval loader, or for the audio trainer only the sampler): the
eval samples from the EMA weights, the video trainer's with the cached
video samplers, the AV trainers' with the window samplers; with
``eval_media_dir`` the AV trainers export the decoded clip and the audio
trainer a decoded WAV through the VAE bridge (utils/owl_vae_bridge.py),
which also encodes the audio trainer's waveforms when it names a VAE.
With ``train.profile_dir`` the loop writes a torch.profiler trace of
steps ``profile_start`` (10) to ``profile_start + 3`` there, with the
records of the step's spans and of the loop's ``owl.train.drain``,
``owl.train.eval`` and ``owl.train.save`` (utils/profiling.py). Each
log also holds ``data/batches``, ``data/wait_s`` and
``data/empty_gets``: the batches the loop took, the seconds it waited
for them and the gets that found none ready since the last log
(data/prefetch.py).
The noise comes from one ``torch.Generator`` on the device, seeded 1234
plus the batch rank (data x fsdp), so the tensor and seq ranks of one
batch rank draw alike. Under several processes every rank starts from
rank 0's initial parameters (sliced by the sharding rules under the fsdp
and tensor axes), loads the shard of its batch rank (data/__init__.py),
and only rank 0 logs and writes checkpoints (trainers/base.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data import get_loader
from ..data.prefetch import counts as prefetch_counts
from ..models import get_model_cls
from ..parallel.dist import broadcast_from_main
from ..utils.logging import DeferredMetrics
from ..utils.mfu import MFUProfiler
from ..utils.profiling import StepProfiler, span
from ..parallel.sharding import shard_params
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
            if self.sharded:
                shard_params(self._eval_core, self.mesh)
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

        batches = self.data_stream(self.train_cfg.data_id,
                                   self.train_cfg.batch_size,
                                   self.train_cfg.data_kwargs)
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
            1234 + self.mesh.batch_rank)
        self.timer.reset()
        self.install_preemption_handler()
        try:
            return self._train_loop(state, max_steps, accum, batches,
                                    sampler, sample_loader, profiler,
                                    generator)
        finally:
            self.restore_preemption_handler()

    def _train_loop(self, state, max_steps, accum, batches, sampler,
                    sample_loader, profiler, generator):
        step_profiler = StepProfiler(self.train_cfg.get("profile_dir"),
                                     start=self.train_cfg.get(
                                         "profile_start", 10))
        total = max_steps if max_steps is not None else \
            self.train_cfg.get("max_steps") or int(1e12)
        pending = DeferredMetrics()
        log_interval = self.log_interval()
        clip = self.grad_clip_norm()
        profiler.start()
        waited = prefetch_counts()

        while self.total_step_counter < total:
            if self.should_stop():
                for _, m in pending.drain():
                    self.metrics.log_dict(m)
                self.save(state)
                break
            micro = [next(batches) for _ in range(accum)]
            step_profiler.maybe_start(self.total_step_counter)
            metrics = self.train_step(state, micro, generator, clip_norm=clip)
            pending.append(self.total_step_counter + 1, metrics)
            step_profiler.maybe_stop(self.total_step_counter)
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
            with span("owl.train.drain", self.total_step_counter):
                drained = pending.drain()
                for _, m in drained:
                    self.metrics.log_dict(m)
            profiler.stop(n_steps=len(drained))
            log = self.metrics.pop()
            log["time"] = self.timer.hit() / max(1, len(drained))
            log.update(profiler.report())
            counts = prefetch_counts()
            log.update({f"data/{k}": v - waited[k]
                        for k, v in counts.items()})
            waited = counts
            if do_sample:
                with span("owl.train.eval", self.total_step_counter):
                    log.update(self.eval_step(state, sample_loader,
                                              sampler))
            if self.is_main:
                self.logger.log(log, step=self.total_step_counter)
            if do_save:
                with span("owl.train.save", self.total_step_counter):
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
    _media_decoders = None

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

    def media_decoders(self):
        """(video frame decoder, audio decode) of the eval export, built
        once on the trainer's device: the bridge's decoder of ``vae_id``
        (with ``vae_cfg_path`` / ``vae_ckpt_path``) and the bridge's
        audio decoder of ``audio_channels`` on seeded weights (the JAX
        trainer reads no audio VAE checkpoint here)."""
        if self._media_decoders is None:
            from ..utils.owl_vae_bridge import (get_audio_encoder_decoder,
                                                get_decoder_only)
            tc = self.train_cfg
            dec = get_decoder_only(tc.vae_id, tc.get("vae_cfg_path"),
                                   tc.get("vae_ckpt_path"),
                                   latent_channels=self.model_cfg.channels,
                                   device=self.device)
            _, adec = get_audio_encoder_decoder(
                latent_channels=self.model_cfg.audio_channels,
                device=self.device)
            self._media_decoders = (dec, adec)
        return self._media_decoders

    def decode_media(self, video_latents, audio_latents, mouse, btn):
        """The first clip of a sample, cropped to the trailing window its
        streams share (a window sampler may return more latents than
        controls), decoded ``vae_batch_size`` at a time: (frames [n, H, W,
        3], waveform [n * 735, 2], mouse [n, 2], buttons [n, k]), numpy
        float32."""
        from ..utils.owl_vae_bridge import (make_batched_audio_decode_fn,
                                            make_batched_decode_fn)
        tc = self.train_cfg
        n = min(video_latents.shape[1], audio_latents.shape[1],
                mouse.shape[1], btn.shape[1])
        dec, adec = self.media_decoders()
        frames = make_batched_decode_fn(dec, tc.vae_batch_size)(
            video_latents[:1, -n:] * tc.vae_scale)[0]
        wf = make_batched_audio_decode_fn(adec, tc.vae_batch_size)(
            audio_latents[:1, -n:] * tc.get("audio_vae_scale", 1.0))[0]
        return tuple(x.float().cpu().numpy()
                     for x in (frames, wf, mouse[0, -n:], btn[0, -n:]))

    def _export_media(self, video_latents, audio_latents, mouse, btn):
        """With ``eval_media_dir``: the decoded first clip written as
        step_<n>.gif / .wav and one muxed AV file, controls drawn on the
        frames (utils/media.py ``save_av_bundle``)."""
        out_dir = self.train_cfg.get("eval_media_dir")
        if not out_dir or not self.is_main:
            return
        from ..utils.media import save_av_bundle
        frames, wf, mouse, btn = self.decode_media(
            video_latents, audio_latents, mouse, btn)
        save_av_bundle(out_dir, f"step_{self.total_step_counter}",
                       video_frames=frames, waveform=wf, mouse=mouse,
                       buttons=btn)


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


class AudioRFTTrainer(RFTFamilyTrainer):
    """Unconditional audio RFT. Batch: [latents [b, n, c]], or with
    ``vae_ckpt_path`` / ``vae_cfg_path`` [waveforms [b, T, 2]], which the
    frozen encoder of the bridge (64 latent channels; the checkpoint at
    ``vae_ckpt_path + "_enc"``, else seeded weights) encodes and divides
    by ``vae_scale`` each step. With ``eval_media_dir`` the eval decodes
    its first sample through the bridge's decoder (``vae_ckpt_path +
    "_dec"``) and writes audio_<step>.wav."""

    model_id = "audio_rft"
    eval_reads_loader = False

    def __init__(self, cfg, device=None):
        super().__init__(cfg, device)
        tc = self.train_cfg
        self.encode_fn = self._audio_decoder = None
        if tc.get("vae_ckpt_path") or tc.get("vae_cfg_path"):
            from ..utils.owl_vae_bridge import get_audio_encoder_decoder
            self.encode_fn, _ = get_audio_encoder_decoder(
                tc.get("vae_cfg_path"), tc.get("vae_ckpt_path"),
                device=self.device)

    def _seq_tokens(self) -> int:
        """One token a latent, ``sample_size`` a sample, also when the
        loader's windows count waveform samples (as the JAX trainer
        counts them)."""
        return self.model_cfg.sample_size

    def to_latents(self, x: torch.Tensor) -> torch.Tensor:
        """Waveforms [b, T, 2] -> encoded latents over ``vae_scale`` when
        the trainer has an encoder; anything else as it is."""
        if x.ndim == 3 and x.shape[-1] == 2 and self.encode_fn is not None:
            return self.encode_fn(x) / self.train_cfg.vae_scale
        return x

    def loss_fn(self, model, batch, generator):
        loss = model(self.to_latents(batch[0]).to(torch.bfloat16),
                     generator=generator)
        return loss, {"diffusion_loss": loss.detach()}

    def eval_step(self, state, sample_loader, sampler):
        """Sample from the EMA weights with the configured sampler;
        returns the std of the latents, and with ``eval_media_dir`` writes
        the first sample's decoded waveform."""
        c, tc = self.model_cfg, self.train_cfg
        b = min(tc.n_samples, 4)
        gen = self.eval_generator(7)
        ctx = torch.randn(b, c.sample_size // 2, c.channels, generator=gen,
                          device=self.device).to(torch.bfloat16)
        latents = sampler(self.ema_core(state), ctx,
                          generator=gen.manual_seed(8))
        out = {"eval/audio_latent_std":
               latents.float().std(correction=0).item()}
        out_dir = tc.get("eval_media_dir")
        if out_dir and self.is_main:
            import os
            from ..utils.media import write_wav
            from ..utils.owl_vae_bridge import (
                get_audio_encoder_decoder, make_batched_audio_decode_fn)
            if self._audio_decoder is None:
                _, dec = get_audio_encoder_decoder(
                    tc.get("vae_cfg_path"), tc.get("vae_ckpt_path"),
                    latent_channels=c.channels, device=self.device)
                self._audio_decoder = make_batched_audio_decode_fn(
                    dec, tc.vae_batch_size)
            wf = self._audio_decoder(latents[:1] * tc.vae_scale)[0]
            os.makedirs(out_dir, exist_ok=True)
            write_wav(os.path.join(
                out_dir, f"audio_{self.total_step_counter}.wav"),
                wf.float().cpu().numpy())
        return out
