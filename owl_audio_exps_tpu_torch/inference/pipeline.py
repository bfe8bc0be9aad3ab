"""Real-time window-recompute streaming pipeline (counterpart of
inference/pipeline.py ``CausvidPipeline``).

Per tick: re-noise the history window to ``alpha``, append a pure-noise
frame, shift the control buffers, run ``sampling_steps`` Euler updates
(dt = 1 / steps) of the final frame over the full window, then shift the
history. Every denoise step is one uncached forward of the whole window
(60 frames x 65 tokens at the reference geometry), so each of its
attention layers runs the frame-mask flash kernel on the card.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..sampling.common import randn, zlerp
from ..utils.device import resolve_device


@dataclass
class StreamBuffers:
    history: torch.Tensor   # [1, W, c, h, w]
    audio: torch.Tensor     # [1, W, c_a]
    mouse: torch.Tensor     # [1, W, 2]
    button: torch.Tensor    # [1, W, n_buttons]

    def clone(self) -> "StreamBuffers":
        return StreamBuffers(self.history.clone(), self.audio.clone(),
                             self.mouse.clone(), self.button.clone())


class CausvidPipeline:
    """Streaming AV generation with a distilled (1-2 step) core.

    ``core`` is a port ``GameRFTAudioCore`` on ``device`` (default
    "cuda", which raises without a card; pass ``device="cpu"`` for CPU
    runs). Noise comes from a ``torch.Generator`` seeded with ``seed``.
    """

    def __init__(self, core, config, frame_decode_fn=None,
                 image_scale: float = 1.0, window_length: int = 60,
                 alpha: float = 0.2, sampling_steps: int = 1, seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.core = core
        self.config = config
        self.frame_decode_fn = frame_decode_fn
        self.image_scale = image_scale
        self.W = window_length
        self.alpha = alpha
        self.sampling_steps = sampling_steps
        self.min_samps, self.max_samps = 1, 20
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        c = config
        zeros = lambda *s: torch.zeros(s, dtype=torch.bfloat16,  # noqa: E731
                                       device=self.device)
        self.buffers = StreamBuffers(
            history=zeros(1, self.W, c.channels, c.sample_size,
                          c.sample_size),
            audio=zeros(1, self.W, c.audio_channels),
            mouse=zeros(1, self.W, c.get("n_mouse_axes", 2)),
            button=zeros(1, self.W, c.n_buttons))
        self._initial = self.buffers.clone()

    # --------------------------------------------------------- buffers
    def restart_from_buffer(self):
        self.buffers = self._initial.clone()

    def up_sampling_steps(self):
        self.sampling_steps = min(self.sampling_steps + 1, self.max_samps)

    def down_sampling_steps(self):
        self.sampling_steps = max(self.sampling_steps - 1, self.min_samps)

    # ------------------------------------------------------------- tick
    @torch.no_grad()
    def _denoise_window(self, x, a, ts, mouse, btn, n_steps: int):
        """``n_steps`` Euler updates (dt = 1 / n_steps) of the final frame,
        each from one forward of the whole window. Returns (x, a, ts)."""
        dt = 1.0 / n_steps
        for _ in range(n_steps):
            pv, pa = self.core(x, a, ts, mouse, btn)
            x, a, ts = x.clone(), a.clone(), ts.clone()
            x[:, -1] = (x[:, -1].float() - dt * pv[:, -1].float()).to(x.dtype)
            a[:, -1] = (a[:, -1].float() - dt * pa[:, -1].float()).to(a.dtype)
            ts[:, -1] = ts[:, -1] - dt
        return x, a, ts

    @torch.no_grad()
    def _tick(self, new_mouse, new_btn, n_steps: int):
        buf, gen, dev = self.buffers, self.generator, self.device
        new_mouse = torch.as_tensor(new_mouse, dtype=torch.float32,
                                    device=dev).to(torch.bfloat16)
        new_btn = torch.as_tensor(new_btn, dtype=torch.float32,
                                  device=dev).to(torch.bfloat16)

        hist = zlerp(buf.history[:, 1:], self.alpha, gen)
        aud = zlerp(buf.audio[:, 1:], self.alpha, gen)
        x = torch.cat([hist, randn(hist[:, :1].shape, hist.dtype, dev, gen)],
                      dim=1)
        a = torch.cat([aud, randn(aud[:, :1].shape, aud.dtype, dev, gen)],
                      dim=1)
        mouse = torch.cat([buf.mouse[:, 1:], new_mouse[None, None, :]], dim=1)
        button = torch.cat([buf.button[:, 1:], new_btn[None, None, :]], dim=1)
        ts = torch.full((1, self.W), self.alpha, dtype=torch.bfloat16,
                        device=dev)
        ts[:, -1] = 1.0

        x, a, _ = self._denoise_window(x, a, ts, mouse, button, n_steps)
        new_frame, new_audio = x[:, -1:], a[:, -1:]
        self.buffers = replace(
            buf, history=torch.cat([buf.history[:, 1:], new_frame], dim=1),
            audio=torch.cat([buf.audio[:, 1:], new_audio], dim=1),
            mouse=mouse, button=button)
        return new_frame[0], new_audio[0]

    def __call__(self, new_mouse, new_btn):
        """new_mouse: [2] floats; new_btn: [n_buttons] in {0, 1}.

        Returns (frame, audio_latent, model_time_s); frame is the decoded
        frame when a decoder is set, else the latent [1, c, h, w]."""
        t0 = time.perf_counter()
        frame_lat, audio_lat = self._tick(np.asarray(new_mouse, np.float32),
                                          np.asarray(new_btn, np.float32),
                                          self.sampling_steps)
        if self.frame_decode_fn is not None:
            frame = self.frame_decode_fn(frame_lat * self.image_scale)[0]
        else:
            frame = frame_lat
        if frame.is_cuda:
            torch.cuda.synchronize(frame.device)
        return frame, audio_lat, time.perf_counter() - t0
