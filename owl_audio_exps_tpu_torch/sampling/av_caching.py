"""Frame-at-a-time streaming video samplers over the ring KV cache
(counterpart of owl_audio_exps_tpu/sampling/av_caching.py).

``AVCachingSamplerV2`` (the registered ``av_caching``) caches the context
once at ``noise_prev``, then for each new frame runs an Euler denoise
from t = 1 against the ring (with in-loop CFG on null controls when
``cfg_scale`` is not 1) and writes the clean frame, re-noised at
``noise_prev``, into the ring, whose capacity evicts the oldest frame
(the rolling ``max_window``). With ``fused_write`` frame i's ring write
is folded into frame i + 1's first conditional forward, one 2-frame
causal forward that commits only its first frame (``write_len=1``); the
unconditional leg runs after that commit. ``chunked_prefill`` writes the
context frame by frame through the decoding path (``"auto"``: at ring
capacities of 2,048 frames and more). ``AVCachingSampler`` (v1) is the
same loop with a separate write-forward per frame and no CFG;
``AVCachingOneStepSampler`` defaults to the one-step schedule [1.0].

The JAX package runs the frame loop as one jitted ``lax.scan``
(``loop_mode`` "scan") or as a jitted tick driven from the host
(``"host"``), with identical outputs. Here there is one loop
(``FrameLoop``, sampling/common.py ``StepLoop``): one frame's step works
on static buffers (the ring and its device counters, the pending frame,
the controls, the run's draws indexed by a device-side frame counter, the
output frames), is replayed from a CUDA graph on the card and runs
eagerly on the CPU; ``loop_mode`` accepts the JAX values and changes
nothing. RoPE rebases (sessions that outlive the position table) run
between the replays of two segments, as the JAX package runs them between
its scans.

Draws: the context's re-noise [b, init_len, c, h, w] and each frame's
initial and re-noise draws [num_frames, b, 1, c, h, w], float32
(``SamplerNoise``), from a ``torch.Generator`` or from the caller, as the
tests hand in the JAX sampler's own draws. The controls are indexed as
the JAX sampler indexes them: frame i reads control ``init_len + i`` of
``mouse`` / ``btn`` after the context has been cut to its window.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..nn.kv_cache import KVCache, rope_rebase_plan, rope_rebase_segments
from .common import (SamplerNoise, StepLoop, check_noise, draw_noise,
                     graphs_allowed, zlerp)
from .schedulers import resolve_schedule, scan_or_unroll

LOOP_MODES = ("auto", "scan", "host")


class FrameLoop(StepLoop):
    """The static buffers of one generation and one frame's step on them:
    the ring cache, the pending (deferred) frame, the controls, the run's
    draws, the output [num_frames, b, c, h, w] and the frame counter
    ``i``."""

    def __init__(self, sampler, config, x, mouse, btn, num_frames: int,
                 capacity: int):
        super().__init__(x.device)
        # the sampler's settings, copied (see sampling/audio_caching.py
        # TokenLoop: no reference back to the sampler that keeps the loop)
        self.schedule = sampler.schedule
        self.fused_write = sampler.fused_write
        self.noise_prev = sampler.noise_prev
        self.cfg_scale = sampler.cfg_scale
        self.dtype = dtype = x.dtype
        b, self.init_len = x.shape[0], x.shape[1]
        item = tuple(x.shape[2:])
        kw = dict(device=x.device)
        self.cache = KVCache.from_config(config, b, capacity_frames=capacity,
                                         dtype=dtype, device=x.device)
        self.pending = torch.zeros((b, 1) + item, dtype=dtype, **kw)
        self.init = torch.zeros((num_frames, b, 1) + item, **kw)
        self.renoise = torch.zeros((num_frames, b, 1) + item, **kw)
        self.frames = torch.zeros((num_frames, b) + item, dtype=dtype, **kw)
        self.mouse = torch.zeros_like(mouse)
        self.btn = torch.zeros_like(btn)
        self.null_mouse = torch.zeros_like(mouse[:, :1])
        self.null_btn = torch.zeros_like(btn[:, :1])
        self.i = torch.zeros(1, dtype=torch.long, **kw)
        self.t_one = torch.ones(b, 1, dtype=dtype, **kw)
        self.t_prev = torch.full((b, 1), sampler.noise_prev, dtype=dtype,
                                 **kw)

    def velocity(self, core, x, t, mouse, btn, **kw):
        """The conditional velocity, guided by the unconditional one on
        null controls (after a write, against the committed ring)."""
        pred = core(x, t, mouse, btn, kv_cache=self.cache, **kw)
        if self.cfg_scale == 1.0:
            return pred
        if kw.get("write"):
            pred = pred[:, -1:]
        pred_u = core(x[:, -1:], t[:, -1:], self.null_mouse, self.null_btn,
                      kv_cache=self.cache, decoding=True)
        return pred_u + self.cfg_scale * (pred - pred_u)

    def step(self, core):
        """Generate frame ``i`` and advance ``i``."""
        dtype, dt = self.dtype, self.schedule
        start = self.i + self.init_len
        cur_m = self.mouse.index_select(1, start)
        cur_b = self.btn.index_select(1, start)
        cur = self.init.index_select(0, self.i)[0].to(dtype)
        t = self.t_one
        rest = dt
        if self.fused_write:
            # one forward: [pending at noise_prev with its own controls,
            # cur at 1.0]; it commits pending's KV and gives cur's first
            # conditional velocity
            both = torch.cat([start - 1, start])
            pred = self.velocity(
                core, torch.cat([self.pending, cur], dim=1),
                torch.cat([self.t_prev, t], dim=1),
                self.mouse.index_select(1, both),
                self.btn.index_select(1, both), write=True, write_len=1)
            d0 = float(dt[0])
            cur = (cur.float() - d0 * pred[:, -1:].float()).to(dtype)
            t = (t.float() - d0).to(dtype)
            rest = dt[1:]

        def denoise(state, dt_i):
            cur, t = state
            pred = self.velocity(core, cur, t, cur_m, cur_b, decoding=True)
            # the Euler update in float32; the carry stays in the model dtype
            return ((cur.float() - dt_i * pred.float()).to(dtype),
                    (t.float() - dt_i).to(dtype)), None

        cur, t = scan_or_unroll(denoise, (cur, t), rest)
        noisy = zlerp(cur, self.noise_prev,
                      z=self.renoise.index_select(0, self.i)[0])
        if self.fused_write:
            self.pending.copy_(noisy)
        else:
            core(noisy, self.t_prev, cur_m, cur_b, kv_cache=self.cache,
                 write=True, decoding=True)
        self.frames.index_copy_(0, self.i, cur[:, 0][None])
        self.i.add_(1)


class AVCachingSamplerV2:
    """
    :param n_steps: diffusion steps per frame
    :param cfg_scale: classifier-free guidance scale (1.0 disables)
    :param num_frames: new frames to generate
    :param noise_prev: noise level the cached history is held at
    :param max_window: rolling context bound in frames (ring capacity)
    :param custom_schedule: e.g. [1.0, 0.5] for 2-step distilled students
    :param only_return_generated: drop the context from the output
    :param loop_mode: the JAX package's "auto" / "scan" / "host"; the port
        has one loop (see the module docstring)
    :param chunked_prefill: True, False or "auto" (capacity >= 2048)
    :param fused_write: fold each frame's ring write into the next frame's
        first conditional forward
    """

    def __init__(self, n_steps: int = 16, cfg_scale: float = 1.3,
                 num_frames: int = 60, noise_prev: float = 0.2,
                 max_window=None, custom_schedule=None,
                 only_return_generated: bool = False,
                 loop_mode: str = "auto", chunked_prefill="auto",
                 fused_write: bool = True, **_):
        if loop_mode not in LOOP_MODES:
            raise ValueError(f"loop_mode {loop_mode!r}: one of {LOOP_MODES}")
        if chunked_prefill not in (True, False, "auto"):
            raise ValueError(f"chunked_prefill {chunked_prefill!r}: True, "
                             "False or 'auto'")
        self.n_steps = n_steps
        self.cfg_scale = cfg_scale
        self.num_frames = num_frames
        self.noise_prev = noise_prev
        self.max_window = max_window
        self.custom_schedule = (list(custom_schedule)
                                if custom_schedule is not None else None)
        self.only_return_generated = only_return_generated
        self.loop_mode = loop_mode
        self.chunked_prefill = chunked_prefill
        self.fused_write = fused_write
        self.schedule = resolve_schedule(n_steps, self.custom_schedule)
        self._loops = {}

    def _use_chunked_prefill(self, capacity: int) -> bool:
        if self.chunked_prefill == "auto":
            return capacity >= 2048
        return bool(self.chunked_prefill)

    def __call__(self, core, x, mouse, btn,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[SamplerNoise] = None):
        """core: GameRFTCore; x: [b, init_len, c, h, w] context latents;
        mouse / btn cover init_len + num_frames frames. Returns
        [b, min(init_len, window) + num_frames, c, h, w] (the new frames
        alone with ``only_return_generated``). On a CUDA device the frames
        come from CUDA-graph replays of one frame's step (eager steps
        under a mesh that shards the weights: ``graphs_allowed``)."""
        return self._sample(core, x, mouse, btn, generator, noise,
                            graphed=graphs_allowed(x.device))

    def sample_eager(self, core, x, mouse, btn,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[SamplerNoise] = None):
        """The same generation with every step run eagerly: the reference
        that the CUDA-graph replays are held to on the card."""
        return self._sample(core, x, mouse, btn, generator, noise,
                            graphed=False)

    def frames_to_generate(self, x, mouse) -> int:
        return min(self.num_frames, mouse.shape[1] - x.shape[1])

    def window(self, x, num_frames: int):
        """(x cut to its trailing window, ring capacity in frames)."""
        capacity = self.max_window or (x.shape[1] + num_frames)
        return x[:, -capacity:], capacity

    def prepare(self, core, x, mouse, btn, noise: SamplerNoise) -> FrameLoop:
        """The loop of this (core, shape), reset to a new run: controls and
        draws copied in, the context written into the ring at
        ``noise_prev`` (with ``fused_write`` all but its last frame, which
        becomes the pending write); ``x`` is cut to its window first. An
        AV core (one with an audio stream) raises TypeError: the sampler
        calls a video core, and the JAX package's fails on an AV core
        too."""
        self.check_core(core)
        n = self.frames_to_generate(x, mouse)
        x, capacity = self.window(x, n)
        b, init_len = x.shape[:2]
        item = tuple(x.shape[2:])
        check_noise(noise, ctx=x.shape, init=(n, b, 1) + item,
                    renoise=(n, b, 1) + item)
        key = (id(core), tuple(x.shape), tuple(mouse.shape), mouse.dtype,
               tuple(btn.shape), btn.dtype, n, capacity, x.dtype,
               str(x.device))
        if key not in self._loops:
            self._loops[key] = (core, FrameLoop(self, core.config, x, mouse,
                                                btn, n, capacity))
        loop = self._loops[key][1]
        loop.cache.reset()
        loop.i.zero_()
        loop.mouse.copy_(mouse)
        loop.btn.copy_(btn)
        loop.init.copy_(noise.init)
        loop.renoise.copy_(noise.renoise)

        noisy = zlerp(x, self.noise_prev, z=noise.ctx)
        t_ctx = torch.full((b, init_len), self.noise_prev, dtype=x.dtype,
                           device=x.device)
        if self.fused_write:
            # the last context frame becomes the first fused forward's
            # pending write (the same attention set)
            if init_len > 1:
                self._prefill(core, loop, noisy[:, :-1], t_ctx[:, :-1],
                              mouse, btn, capacity)
            loop.pending.copy_(noisy[:, -1:])
        else:
            self._prefill(core, loop, noisy, t_ctx, mouse, btn, capacity)
        return loop

    def check_core(self, core):
        """Raise TypeError for an AV core (one with an audio stream)."""
        if hasattr(core, "audio_proj_in"):
            raise TypeError(
                f"{type(self).__name__} samples a video core (x, t, mouse, "
                f"btn); {type(core).__name__} also takes an audio stream. "
                "The JAX package's sampler fails on an AV core as well; the "
                "AV cores serve through the window samplers "
                "(sampling/av_window.py) and AVCachedStreamingPipeline "
                "(inference/pipeline.py)")

    def _prefill(self, core, loop, noisy, t_ctx, mouse, btn, capacity):
        """Write the noised context into the ring: one forward, or frame by
        frame through the decoding path for giant rings."""
        n = noisy.shape[1]
        if not self._use_chunked_prefill(capacity):
            core(noisy, t_ctx, mouse[:, :n], btn[:, :n],
                 kv_cache=loop.cache, write=True)
            return
        for i in range(n):
            sl = slice(i, i + 1)
            core(noisy[:, sl], t_ctx[:, sl], mouse[:, sl], btn[:, sl],
                 kv_cache=loop.cache, write=True, decoding=True)

    @torch.no_grad()
    def _sample(self, core, x, mouse, btn, generator, noise, graphed: bool):
        self.check_core(core)
        n = self.frames_to_generate(x, mouse)
        x, capacity = self.window(x, n)
        b, init_len = x.shape[:2]
        if noise is None:
            noise = draw_noise(generator, b, init_len, tuple(x.shape[2:]), n,
                               x.device)
        loop = self.prepare(core, x, mouse, btn, noise)
        # sessions longer than the RoPE table: segments with an exact ring
        # rebase between them (one segment, no rebase, in the common case)
        table_f, delta_f, rebase = rope_rebase_plan(core.config, capacity)
        for si, seg in enumerate(rope_rebase_segments(init_len, n, table_f,
                                                      delta_f)):
            if si:
                rebase(loop.cache)
            loop.run(core, seg, graphed)
        out = torch.cat([x, loop.frames.transpose(0, 1)], dim=1)
        return out[:, -n:] if self.only_return_generated else out


class AVCachingSampler(AVCachingSamplerV2):
    """v1: the JAX package's ``AVCachingSampler``, a separate write-forward
    for each frame, no CFG (``cfg_scale`` must be 1.0), the whole context
    cached in one forward and a ring that holds the whole run."""

    def __init__(self, n_steps: int = 16, cfg_scale: float = 1.0,
                 num_frames: int = 60, noise_prev: float = 0.2,
                 window_length=None, only_return_generated: bool = False,
                 **_):
        if cfg_scale != 1.0:
            raise ValueError("AVCachingSampler(v1) requires cfg_scale 1.0")
        super().__init__(n_steps=n_steps, cfg_scale=1.0,
                         num_frames=num_frames, noise_prev=noise_prev,
                         only_return_generated=only_return_generated,
                         chunked_prefill=False, fused_write=False)


class AVCachingOneStepSampler(AVCachingSamplerV2):
    """One-step distilled-student variant: the schedule [1.0] and no CFG
    unless given."""

    def __init__(self, **kwargs):
        kwargs.setdefault("custom_schedule", [1.0])
        kwargs.setdefault("cfg_scale", 1.0)
        super().__init__(**kwargs)
