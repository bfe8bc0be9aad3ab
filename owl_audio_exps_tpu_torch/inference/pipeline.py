"""Real-time streaming pipelines (counterpart of inference/pipeline.py).

``CausvidPipeline`` recomputes the window. Per tick: re-noise the history
window to ``alpha``, append a pure-noise frame, shift the control
buffers, run ``sampling_steps`` Euler updates (dt = 1 / steps) of the
final frame over the full window, then shift the history. Every denoise
step is one uncached forward of the whole window (60 frames x 65 tokens
at the reference geometry), so each of its attention layers runs the
frame-mask flash kernel on the card.

``CachedStreamingPipeline`` (``GameRFTCore``) and
``AVCachedStreamingPipeline`` (``GameRFTAudioCore``) hold a ring KV cache
across ticks instead. ``prime`` caches a context clip at ``noise_prev``;
each tick denoises one frame (and its audio latent) from t = 1 against
the ring with ``sampling_steps`` single-frame forwards (the schedule
[1.0, 0.5] at 2 steps) and re-noises it at ``noise_prev``. Tick modes, as
in the JAX package: ``plain`` writes the re-noised frame with one more
forward; with ``fused_write`` the write is deferred into the next tick's
first forward, a 2-frame forward that commits only the pending frame
(``steady``), and a session's first tick with nothing pending only
produces one (``first``). ``n_sessions`` sessions tick in lockstep on
one ring, one batch row each. The host knows the ring's write offset, so
when the next frame would leave the RoPE table an exact rebase
(nn/kv_cache.py ``rope_rebase_plan``) runs between ticks and sessions
are unbounded. Cached attention runs the decode kernel
(ops/decode_attention.py, routed by nn/attn.py ``cached_attention``) on
the card, where the JAX package runs plain XLA. With
``frame_decode_fn`` / ``audio_decode_fn`` (utils/owl_vae_bridge.py) a
tick returns the decoded frames as the JAX pipelines shape them
([n_sessions, 1, H, W, 3], one session [1, H, W, 3]) and the waveforms
[n_sessions, 735, 2]; decoding runs after the tick, outside its graph,
as the JAX package decodes after its jitted tick.

The JAX package runs each tick as one jitted program. Here a tick works
on static buffers (sampling/common.py ``StepLoop``): the ring, the
pending frame and its controls, this tick's controls and draws, and the
output; on the card the ``steady`` tick is captured once as a CUDA graph
and replayed every tick, after the host has copied the tick's controls
and draws into their buffers. ``first``, ``plain`` and the rebase run
eagerly. Draws come from a ``torch.Generator`` seeded with ``seed``, or
from the caller (the tests hand in the JAX pipeline's draws): ``prime``
takes the context's noise per stream, a tick each stream's initial and
re-noise draws (``TickNoise``), all float32 as the JAX pipeline draws
them, rounded to bfloat16, in which the pipelines keep latents and
rings.
"""

from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass, replace
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..nn.kv_cache import KVCache, rope_rebase_plan
from ..parallel.mesh import get_mesh
from ..sampling.common import StepLoop, graphs_allowed, randn, zlerp
from ..sampling.schedulers import resolve_schedule
from ..utils.device import resolve_device

BF16 = torch.bfloat16


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
    ``frame_decode_fn`` decodes each tick's frame after the tick; it is
    handed the latent [1, c, h, w], as the JAX pipeline hands it (so the
    bridge's ``make_batched_decode_fn``, which reads [b, n, c, h, w],
    refuses it in both packages). ``audio_decode_fn`` is kept and not
    called, as in the JAX pipeline.
    """

    def __init__(self, core, config, frame_decode_fn=None,
                 audio_decode_fn=None,
                 image_scale: float = 1.0, audio_scale: float = 1.0,
                 window_length: int = 60, alpha: float = 0.2,
                 sampling_steps: int = 1, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.core = core
        self.config = config
        self.frame_decode_fn = frame_decode_fn
        self.audio_decode_fn = audio_decode_fn
        self.image_scale = image_scale
        self.audio_scale = audio_scale
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
    def load_cache(self, cache_dir: str = "data_cache",
                   cache_idx: Optional[int] = None):
        """Warm-start the buffers from ``buffers_{idx}.npz`` (history,
        audio, mouse, button; inference/build_cache.py writes them), the
        latents divided by their scales; a random index in [0, 99] unless
        ``cache_idx`` is given."""
        idx = cache_idx if cache_idx is not None else random.randint(0, 99)
        data = np.load(os.path.join(cache_dir, f"buffers_{idx}.npz"))

        def dev(a):
            return torch.from_numpy(np.asarray(a)).to(self.device, BF16)

        self.buffers = StreamBuffers(
            history=dev(data["history"] / self.image_scale),
            audio=dev(data["audio"] / self.audio_scale),
            mouse=dev(data["mouse"]), button=dev(data["button"]))
        self._initial = self.buffers.clone()

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


# ---------------------------------------------------------------- cached
class TickNoise(NamedTuple):
    """One tick's float32 draws, one per latent stream (video, or video
    and audio), each [n_sessions, 1, *item]."""
    init: Tuple[torch.Tensor, ...]
    renoise: Tuple[torch.Tensor, ...]


def tick_schedule(n_steps: int) -> np.ndarray:
    """The serve schedule: [1.0, 0.5] at 2 steps, else the SD3 Euler."""
    return resolve_schedule(n_steps, [1.0, 0.5] if n_steps == 2 else None)


class ServeLoop(StepLoop):
    """A cached serve session's static buffers and one tick on them
    (``step(core, n_steps, mode)``): the ring, the pending frame and its
    controls, this tick's controls and draws, and the output, each latent
    stream in bfloat16."""

    def __init__(self, config, items, n_sessions: int, window_frames: int,
                 noise_prev: float, device):
        super().__init__(device)
        B = n_sessions
        self.noise_prev = noise_prev

        def zeros(*shape, dtype=BF16):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.cache = KVCache.from_config(config, B,
                                         capacity_frames=window_frames,
                                         dtype=BF16, device=device)
        axes = (config.get("n_mouse_axes", 2), config.n_buttons)
        self.mouse, self.btn = (zeros(B, 1, a) for a in axes)
        self.p_mouse, self.p_btn = (zeros(B, 1, a) for a in axes)
        self.pending = tuple(zeros(B, 1, *it) for it in items)
        self.init = tuple(zeros(B, 1, *it, dtype=torch.float32)
                          for it in items)
        self.renoise = tuple(zeros(B, 1, *it, dtype=torch.float32)
                             for it in items)
        self.out = tuple(zeros(B, *it) for it in items)
        self.t_one = torch.ones(B, 1, dtype=BF16, device=device)
        self.t_prev = torch.full((B, 1), noise_prev, dtype=BF16,
                                 device=device)

    def step(self, core, n_steps: int, mode: str):
        def apply(lats, t, mouse, btn, **kw):
            out = core(*lats, t, mouse, btn, kv_cache=self.cache, **kw)
            return out if isinstance(out, tuple) else (out,)

        def euler(lats, preds, t, d):
            return (tuple((x.float() - d * p[:, -1:].float()).to(x.dtype)
                          for x, p in zip(lats, preds)),
                    (t.float() - d).to(t.dtype))

        dt = tick_schedule(n_steps)
        cur = tuple(z.to(BF16) for z in self.init)
        t = self.t_one
        first = 0
        if mode == "steady":
            # one forward: [pending at noise_prev with its controls, cur
            # at 1.0]; it commits pending's KV and gives cur's velocity
            preds = apply(tuple(torch.cat([p, x], dim=1)
                                for p, x in zip(self.pending, cur)),
                          torch.cat([self.t_prev, t], dim=1),
                          torch.cat([self.p_mouse, self.mouse], dim=1),
                          torch.cat([self.p_btn, self.btn], dim=1),
                          write=True, write_len=1)
            cur, t = euler(cur, preds, t, float(dt[0]))
            first = 1
        for i in range(first, n_steps):
            preds = apply(cur, t, self.mouse, self.btn, decoding=True)
            cur, t = euler(cur, preds, t, float(dt[i]))
        a = self.noise_prev
        noisy = tuple((x.float() * (1.0 - a) + z * a).to(x.dtype)
                      for x, z in zip(cur, self.renoise))
        if mode == "plain":
            apply(noisy, self.t_prev, self.mouse, self.btn, write=True,
                  decoding=True)
        else:
            for p, x in zip(self.pending, noisy):
                p.copy_(x)
            self.p_mouse.copy_(self.mouse)
            self.p_btn.copy_(self.btn)
        for o, x in zip(self.out, cur):
            o.copy_(x[:, 0])


class CachedStreamingPipeline:
    """KV-cached real-time serve for causal (distilled) video students
    (``GameRFTCore``); see the module docstring.

    ``device`` defaults to "cuda", which raises without a card; pass
    ``device="cpu"`` for CPU runs. ``graphed`` (default: on a CUDA
    device, unless the mesh shards the weights: ``graphs_allowed``)
    replays the ``steady`` tick from a CUDA graph. Under the tensor axis
    the ring holds this rank's heads (nn/kv_cache.py)."""

    def __init__(self, core, config, window_frames: int = 120,
                 noise_prev: float = 0.2, sampling_steps: int = 1,
                 frame_decode_fn=None, image_scale: float = 1.0,
                 seed: int = 0, n_sessions: int = 1,
                 fused_write: bool = True, device="cuda",
                 graphed: Optional[bool] = None):
        self.device = resolve_device(device)
        self.core = core
        self.config = config
        self.noise_prev = noise_prev
        self.sampling_steps = sampling_steps
        self.frame_decode_fn = frame_decode_fn
        self.image_scale = image_scale
        self.fused_write = fused_write
        self.n_sessions = n_sessions
        self.graphed = (graphs_allowed(self.device) if graphed is None
                        else graphed)
        # seeded by batch rank: the tensor ranks of one batch rank, which
        # compute shares of the same tick, draw alike
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed + get_mesh().batch_rank)
        self.loop = ServeLoop(config, self.latent_items(), n_sessions,
                              window_frames, noise_prev, self.device)
        # whether a fused session has a frame pending (the first tick of a
        # fused session has none)
        self.has_pending = False
        self._table_f, self._delta_f, self._rebase = rope_rebase_plan(
            config, window_frames)
        self._off_frames = 0

    @property
    def cache(self) -> KVCache:
        return self.loop.cache

    def latent_items(self):
        """Each latent stream's shape per frame."""
        c = self.config
        return [(c.channels, c.sample_size, c.sample_size)]

    def _tensor(self, a):
        return torch.as_tensor(a, device=self.device)

    def _draw(self, shapes):
        return tuple(torch.randn(s, generator=self.generator,
                                 device=self.device) for s in shapes)

    @torch.no_grad()
    def _prime(self, lats, mouse, btn, noise):
        a = self.noise_prev
        lats = tuple(self._tensor(x) for x in lats)
        if noise is None:
            noise = self._draw([x.shape for x in lats])
        noisy = tuple((x.float() * (1.0 - a) + self._tensor(z).float() * a)
                      .to(BF16) for x, z in zip(lats, noise))
        mouse, btn = self._tensor(mouse), self._tensor(btn)
        T = lats[0].shape[1]
        t = torch.full((lats[0].shape[0], T), a, dtype=BF16,
                       device=self.device)
        loop = self.loop
        fused = self.fused_write and T >= 1
        n_write = T - 1 if fused else T
        if n_write:
            self.core(*(x[:, :n_write] for x in noisy), t[:, :n_write],
                      mouse[:, :n_write], btn[:, :n_write],
                      kv_cache=loop.cache, write=True)
        if fused:
            # the last context frame pends into the first tick's fused
            # forward (the same attention set)
            for p, x in zip(loop.pending, noisy):
                p.copy_(x[:, -1:])
            loop.p_mouse.copy_(mouse[:, -1:])
            loop.p_btn.copy_(btn[:, -1:])
            self.has_pending = True
        self._off_frames += T

    def prime(self, ctx_latents, ctx_mouse, ctx_btn,
              noise: Optional[torch.Tensor] = None):
        """Warm-start: cache a context clip [n_sessions, T, c, h, w] at
        ``noise_prev``; ``noise`` is its float32 draw (from the generator
        when not given)."""
        self._prime((ctx_latents,), ctx_mouse, ctx_btn,
                    None if noise is None else (noise,))

    @torch.no_grad()
    def _tick(self, new_mouse, new_btn, noise: Optional[TickNoise]):
        loop, B = self.loop, self.n_sessions
        if self._delta_f >= 1 and self._off_frames + 1 > self._table_f:
            self._rebase(loop.cache)
            self._off_frames -= self._delta_f
        # controls arrive [axes] (one session) or [n_sessions, axes]
        for buf, new in ((loop.mouse, new_mouse), (loop.btn, new_btn)):
            buf.copy_(torch.as_tensor(np.asarray(new, np.float32))
                      .reshape(B, 1, -1))
        if noise is None:
            shapes = [x.shape for x in loop.init]
            noise = TickNoise(self._draw(shapes), self._draw(shapes))
        for bufs, draws in ((loop.init, noise.init),
                            (loop.renoise, noise.renoise)):
            for buf, z in zip(bufs, draws):
                buf.copy_(z)
        if not self.fused_write:
            mode = "plain"
        elif self.has_pending:
            mode = "steady"
        else:
            mode = "first"
        loop.run(self.core, 1, self.graphed and mode == "steady",
                 self.sampling_steps, mode)
        self.has_pending = self.fused_write
        self._off_frames += 1
        return tuple(o.clone() for o in loop.out)

    def __call__(self, new_mouse, new_btn, noise: Optional[TickNoise] = None):
        """new_mouse [2] and new_btn [n_buttons] (or [n_sessions, ...])
        -> (frame, None, model_time_s); frame is the decoded frame when a
        decoder is set, else the latent [n_sessions, c, h, w]."""
        t0 = time.perf_counter()
        frame_lat, = self._tick(new_mouse, new_btn, noise)
        frame = self._decode_frame(frame_lat)
        self._sync(frame)
        return frame, None, time.perf_counter() - t0

    def _decode_frame(self, frame_lat):
        if self.frame_decode_fn is None:
            return frame_lat
        frame = self.frame_decode_fn(frame_lat[:, None] * self.image_scale)
        return frame[0] if self.n_sessions == 1 else frame

    def _sync(self, out):
        if torch.is_tensor(out) and out.is_cuda:
            torch.cuda.synchronize(out.device)


class AVCachedStreamingPipeline(CachedStreamingPipeline):
    """KV-cached real-time serve for the joint AV model
    (``GameRFTAudioCore``): each tick denoises one (frame, audio latent)
    pair against the ring, ``sample_size ** 2 + 1`` query tokens a frame;
    see the module docstring."""

    def __init__(self, core, config, audio_decode_fn=None,
                 audio_scale: float = 1.0, **kw):
        super().__init__(core, config, **kw)
        self.audio_decode_fn = audio_decode_fn
        self.audio_scale = audio_scale

    def latent_items(self):
        return super().latent_items() + [(self.config.audio_channels,)]

    def prime(self, ctx_latents, ctx_audio, ctx_mouse, ctx_btn,
              noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """Warm-start: cache a (video, audio) context clip at
        ``noise_prev``; ``noise`` is (video draw, audio draw)."""
        self._prime((ctx_latents, ctx_audio), ctx_mouse, ctx_btn, noise)

    def __call__(self, new_mouse, new_btn, noise: Optional[TickNoise] = None):
        """-> (frame, audio, model_time_s): the decoded frame and audio
        when decoders are set, else the latents [n_sessions, c, h, w] and
        [n_sessions, c_a]."""
        t0 = time.perf_counter()
        frame_lat, audio_lat = self._tick(new_mouse, new_btn, noise)
        frame = self._decode_frame(frame_lat)
        audio = (self.audio_decode_fn(audio_lat[:, None] * self.audio_scale)
                 if self.audio_decode_fn is not None else audio_lat)
        self._sync(frame)
        return frame, audio, time.perf_counter() - t0
