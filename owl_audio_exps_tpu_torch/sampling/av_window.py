"""Sliding-window diffusion-forcing sampler for the joint AV model
(counterpart of owl_audio_exps_tpu/sampling/av_window.py
``AVWindowSampler``).

Per new frame the last ``window_length`` frames form the working window:
history slots are re-noised to ``noise_prev``, the final slot starts from
pure noise and is denoised over ``n_steps`` Euler steps with 2-pass CFG,
recomputing the whole window each step. The JAX ``lax.scan`` loops are
Python loops here; noise comes from an explicit ``torch.Generator``.
The causal, KV-cached subclasses come with the cached serve slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.controls import batch_permute_to_length
from .common import randn, zlerp
from .schedulers import resolve_schedule


class AVWindowSampler:
    """
    :param n_steps: diffusion steps per frame
    :param cfg_scale: CFG scale
    :param window_length: frames per working window
    :param num_frames: new frames to sample
    :param noise_prev: history noise level
    :param only_return_generated: drop the context from the output
    """

    causal = False
    use_cfg = True

    def __init__(self, n_steps: int = 20, cfg_scale: float = 1.3,
                 window_length: int = 60, num_frames: int = 60,
                 noise_prev: float = 0.2,
                 only_return_generated: bool = False, **_):
        self.n_steps = n_steps
        self.cfg_scale = cfg_scale
        self.window_length = window_length
        self.num_frames = num_frames
        self.noise_prev = noise_prev
        self.only_return_generated = only_return_generated

    @torch.no_grad()
    def __call__(self, core, x, audio, mouse, btn,
                 generator: Optional[torch.Generator] = None,
                 decode_fn=None, audio_decode_fn=None,
                 image_scale=1, audio_scale=1):
        """x: [b, n, c, h, w]; audio: [b, n, c_a]; mouse/btn: [b, n, ...].
        Returns (video_dec, audio_dec, x_lat, audio_lat, mouse, btn); the
        decoded entries are None without decode fns."""
        x_out, a_out, ext_mouse, ext_btn = self._sample(
            core, x, audio, mouse, btn, generator)
        if self.only_return_generated:
            x_out = x_out[:, -self.num_frames:]
            a_out = a_out[:, -self.num_frames:]
            ext_mouse = ext_mouse[:, -self.num_frames:]
            ext_btn = ext_btn[:, -self.num_frames:]
        video_dec = decode_fn(x_out * image_scale) if decode_fn else None
        audio_dec = (audio_decode_fn(a_out * audio_scale)
                     if audio_decode_fn else None)
        return video_dec, audio_dec, x_out, a_out, ext_mouse, ext_btn

    @torch.no_grad()
    def _denoise_frame(self, core, window_x, window_a, window_t,
                       w_mouse, w_btn, dt):
        """Denoise the final slot of the working window (bidirectional);
        ``dt`` is the numpy schedule of per-step deltas."""
        b = window_x.shape[0]
        cond_mask = torch.ones(b, dtype=torch.bool, device=window_x.device)
        wx, wa, wt = window_x, window_a, window_t
        for dt_i in (float(d) for d in dt):
            pv, pa = core(wx, wa, wt, w_mouse, w_btn, has_controls=cond_mask)
            if self.use_cfg:
                pv_u, pa_u = core(wx, wa, wt, w_mouse, w_btn,
                                  has_controls=~cond_mask)
                pv = pv_u + self.cfg_scale * (pv - pv_u)
                pa = pa_u + self.cfg_scale * (pa - pa_u)
            new_x = (wx[:, -1:].float() - pv[:, -1:].float() * dt_i)
            new_a = (wa[:, -1:].float() - pa[:, -1:].float() * dt_i)
            new_t = wt[:, -1:].float() - dt_i
            wx = torch.cat([wx[:, :-1], new_x.to(wx.dtype)], dim=1)
            wa = torch.cat([wa[:, :-1], new_a.to(wa.dtype)], dim=1)
            wt = torch.cat([wt[:, :-1], new_t.to(wt.dtype)], dim=1)
        return wx[:, -1], wa[:, -1]

    def _sample(self, core, x, audio, mouse, btn, generator):
        b, n = x.shape[0], x.shape[1]
        W = self.window_length
        assert n >= W, "context must cover at least one window"
        dt = resolve_schedule(self.n_steps, None)
        ext_mouse, ext_btn = batch_permute_to_length(
            mouse, btn, self.num_frames + W, generator)

        hist_x, hist_a = x[:, -W:], audio[:, -W:]
        frames_x, frames_a = [], []
        for idx in range(self.num_frames):
            # window: history shifted by one (oldest dropped), last = noise
            wx = torch.cat([
                zlerp(hist_x[:, 1:], self.noise_prev, generator),
                randn(hist_x[:, :1].shape, hist_x.dtype, x.device,
                      generator)], dim=1)
            wa = torch.cat([
                zlerp(hist_a[:, 1:], self.noise_prev, generator),
                randn(hist_a[:, :1].shape, hist_a.dtype, x.device,
                      generator)], dim=1)
            wt = torch.cat([
                torch.full((b, W - 1), self.noise_prev, dtype=x.dtype,
                           device=x.device),
                torch.ones((b, 1), dtype=x.dtype, device=x.device)], dim=1)
            new_x, new_a = self._denoise_frame(
                core, wx, wa, wt, ext_mouse[:, idx:idx + W],
                ext_btn[:, idx:idx + W], dt)
            hist_x = torch.cat([hist_x[:, 1:], new_x[:, None]], dim=1)
            hist_a = torch.cat([hist_a[:, 1:], new_a[:, None]], dim=1)
            frames_x.append(new_x)
            frames_a.append(new_a)

        x_out = torch.cat([x, torch.stack(frames_x, dim=1)], dim=1)
        a_out = torch.cat([audio, torch.stack(frames_a, dim=1)], dim=1)
        return x_out, a_out, ext_mouse, ext_btn
