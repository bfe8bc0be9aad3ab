"""Audio VAE trainer (counterpart of
owl_audio_exps_tpu/trainers/audio_vae_trainer.py ``stft_mag``,
``multires_stft_loss`` and ``AudioVAETrainer``): fits nn/audio_vae.py's
encoder / decoder pair on stereo waveforms [b, T, 2].

Loss: L1 on the waveform + ``stft_weight`` x the multi-resolution STFT
magnitude loss + ``latent_weight`` x the latents' mean square. The STFT
window is the symmetric Hann window (``jnp.hanning``, which
``torch.hann_window`` gives only with ``periodic=False``), and the
spectral-convergence term is one Frobenius norm over the whole [b,
frames, bins] tensor. The optimizer is optax's ``adamw(lr,
weight_decay)`` (``opt_kwargs`` lr 1e-4, weight decay 1e-4 by default; no
clipping), the EMA moves with beta 0.999, waveforms enter in bf16, and a
checkpoint is saved every ``save_interval`` steps, as in the JAX trainer.
The VAE holds float32 master weights and computes in ``dtype`` (bf16).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data import get_loader
from ..nn.audio_vae import AudioVAE
from ..parallel.dist import broadcast_from_main
from .base import BaseTrainer, TrainState
from .distill_common import build_simple_opt


def stft_mag(x: torch.Tensor, frame: int, hop: int) -> torch.Tensor:
    """Magnitude STFT of [b, T]: frames of ``frame`` samples every
    ``hop``, symmetric Hann window, rFFT -> [b, 1 + (T - frame) // hop,
    frame // 2 + 1]."""
    win = torch.hann_window(frame, periodic=False, dtype=x.dtype,
                            device=x.device)
    return torch.fft.rfft(x.unfold(-1, frame, hop) * win, dim=-1).abs()


def multires_stft_loss(pred: torch.Tensor, target: torch.Tensor,
                       resolutions=((512, 128), (1024, 256), (2048, 512))
                       ) -> torch.Tensor:
    """pred / target [b, T, 2]: spectral convergence + log-magnitude L1,
    summed over the resolutions and averaged over channels and
    resolutions, in float32."""
    loss = 0.0
    for ch in range(pred.shape[-1]):
        p, t = pred[..., ch].float(), target[..., ch].float()
        for frame, hop in resolutions:
            sp, st = stft_mag(p, frame, hop), stft_mag(t, frame, hop)
            sc = torch.linalg.vector_norm(st - sp) / (
                torch.linalg.vector_norm(st) + 1e-6)
            lm = (torch.log(st + 1e-5) - torch.log(sp + 1e-5)).abs().mean()
            loss = loss + sc + lm
    return loss / (pred.shape[-1] * len(resolutions))


class AudioVAETrainer(BaseTrainer):
    """Fits the audio VAE on [b, T, 2] waveforms; ``device`` defaults to
    the card, ``dtype`` is the VAE's compute dtype."""

    def __init__(self, cfg, device=None, dtype=torch.bfloat16):
        super().__init__(cfg, device)
        self.dtype = dtype
        self.latent_channels = self.model_cfg.get("channels", 64)

    def init_state(self, seed: int = 0) -> TrainState:
        vae = AudioVAE(self.latent_channels, dtype=self.dtype,
                       device=self.device, seed=seed)
        broadcast_from_main(vae)
        kw = dict((self.train_cfg.opt_kwargs or {}).items())
        opt = build_simple_opt("AdamW", dict(
            lr=kw.get("lr", 1e-4),
            weight_decay=kw.get("weight_decay", 1e-4)), vae.parameters())
        ema = {n: p.detach().clone() for n, p in vae.named_parameters()}
        return TrainState(model=vae.train(), ema=ema, optimizer=opt)

    def loss_fn(self, model, batch, generator):
        wf = batch[0]
        tc = self.train_cfg
        recon, z = model(wf)
        l1 = (recon - wf.float()).abs().mean()
        spec = multires_stft_loss(recon, wf)
        lat = z.float().square().mean()
        loss = (l1 + tc.get("stft_weight", 1.0) * spec
                + tc.get("latent_weight", 1e-3) * lat)
        return loss, {"loss": loss.detach(), "l1": l1.detach(),
                      "stft": spec.detach(), "latent_l2": lat.detach()}

    def waveforms(self, batch) -> torch.Tensor:
        """A loader's batch (an array, or a list whose first item is one)
        -> bf16 waveforms on the device."""
        wf = batch[0] if isinstance(batch, (list, tuple)) else batch
        return torch.from_numpy(np.asarray(wf)).to(self.device,
                                                   torch.bfloat16)

    def train(self, max_steps: Optional[int] = None) -> TrainState:
        tc = self.train_cfg
        loader = iter(get_loader(tc.data_id, tc.batch_size,
                                 **dict((tc.data_kwargs or {}).items())))
        state = self.init_state()
        total = max_steps if max_steps is not None else \
            tc.get("max_steps") or int(1e12)
        self.timer.reset()
        self.install_preemption_handler()
        try:
            while self.total_step_counter < total and not self.should_stop():
                metrics = self.train_step(state, [[self.waveforms(
                    next(loader))]], None)
                self.metrics.log_dict({k: float(v)
                                       for k, v in metrics.items()})
                self.total_step_counter += 1
                log = self.metrics.pop()
                log["time"] = self.timer.hit()
                self.timer.reset()
                if self.is_main:
                    self.logger.log(log, step=self.total_step_counter)
                    if self.total_step_counter % tc.save_interval == 0:
                        self.save(state)
        finally:
            self.restore_preemption_handler()
        return state
