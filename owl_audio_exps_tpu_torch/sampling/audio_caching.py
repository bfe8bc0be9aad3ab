"""Token-at-a-time autoregressive audio sampler over the ring KV cache
(counterpart of owl_audio_exps_tpu/sampling/audio_caching.py).

Per token: an Euler denoise from t = 1 against the ring, then the clean
token re-noised at ``noise_prev`` is written into the ring, whose capacity
evicts the oldest token (the rolling ``max_window``). With ``fused_write``
token i's ring write is folded into token i+1's first denoise forward, one
2-token causal forward that commits only its first token
(``write_len=1``): ``n_steps`` forwards a token instead of ``n_steps + 1``,
with the same visibility as the separate write.

The JAX loop is one jitted ``lax.scan``. Here one token's step (``TokenLoop
.step``: the fused forward, the remaining decoding forwards, the re-noise
and the output write) works on static buffers: the ring and its device
counters, the pending token, the run's noise drawn before the loop and
indexed by a device-side token counter, and the output. On a CUDA device
the step runs eagerly a few times on a side stream, is then captured once
as a ``torch.cuda.CUDAGraph`` and replayed for every later token, with no
host work between tokens; on the CPU the same step runs eagerly
(sampling/common.py ``StepLoop``). A failed capture raises. RoPE rebases
(sessions that outlive the position table) run between the replays of
two segments, as the JAX package runs them between its scans.

Random draws: the context noise [b, init_len, c] and each token's initial
and re-noise draws [num_tokens, b, 1, c], all float32 (``SamplerNoise``),
come from a ``torch.Generator`` (``draw_noise``) or from the caller, as
the tests hand in the JAX sampler's own draws. Rounding follows the JAX
sampler: draws cast to the model dtype, the Euler update in float32 with
the carry and ``t`` in the model dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..nn.kv_cache import KVCache, rope_rebase_plan, rope_rebase_segments
from .common import SamplerNoise, StepLoop, check_noise, draw_noise, zlerp
from .schedulers import resolve_schedule, scan_or_unroll


class TokenLoop(StepLoop):
    """The static buffers of one generation and one token's step on them:
    the ring cache, the pending (deferred) token, the run's draws, the
    output [num_tokens, b, c] and the token counter ``i``."""

    def __init__(self, sampler, config, batch: int, channels: int,
                 capacity: int, dtype, device):
        super().__init__(device)
        # the sampler's settings, copied: the sampler keeps its loops, and
        # a loop that pointed back at it would free them (their cores and
        # graphs) only at a garbage collection
        self.schedule = sampler.schedule
        self.fused_write = sampler.fused_write
        self.noise_prev = sampler.noise_prev
        self.dtype = dtype
        n = sampler.num_tokens
        self.cache = KVCache.from_config(config, batch,
                                         capacity_frames=capacity,
                                         dtype=dtype, device=device)
        kw = dict(device=device)
        self.pending = torch.zeros(batch, 1, channels, dtype=dtype, **kw)
        self.init = torch.zeros(n, batch, 1, channels, **kw)
        self.renoise = torch.zeros(n, batch, 1, channels, **kw)
        self.tokens = torch.zeros(n, batch, channels, dtype=dtype, **kw)
        self.i = torch.zeros(1, dtype=torch.long, **kw)
        self.t_one = torch.ones(batch, 1, dtype=dtype, **kw)
        self.t_prev = torch.full((batch, 1), sampler.noise_prev, dtype=dtype,
                                 **kw)

    def step(self, core):
        """Generate token ``i`` and advance ``i``."""
        dtype, cache, dt = self.dtype, self.cache, self.schedule
        cur = self.init.index_select(0, self.i)[0].to(dtype)
        t = self.t_one
        rest = dt
        if self.fused_write:
            # one forward: [pending at noise_prev, cur at 1.0]; it commits
            # pending's KV and gives cur's first velocity
            x2 = torch.cat([self.pending, cur], dim=1)
            t2 = torch.cat([self.t_prev, t], dim=1)
            pred2 = core(x2, t2, kv_cache=cache, write=True, write_len=1)
            d0 = float(dt[0])
            cur = (cur.float() - d0 * pred2[:, -1:].float()).to(dtype)
            t = (t.float() - d0).to(dtype)
            rest = dt[1:]

        def denoise(state, dt_i):
            cur, t = state
            pred = core(cur, t, kv_cache=cache, decoding=True)
            # the Euler update in float32; the carry stays in the model dtype
            return ((cur.float() - dt_i * pred.float()).to(dtype),
                    (t.float() - dt_i).to(dtype)), None

        cur, t = scan_or_unroll(denoise, (cur, t), rest)
        noisy = zlerp(cur, self.noise_prev,
                      z=self.renoise.index_select(0, self.i)[0])
        if self.fused_write:
            self.pending.copy_(noisy)
        else:
            core(noisy, torch.full_like(t, self.noise_prev), kv_cache=cache,
                 write=True, decoding=True)
        self.tokens.index_copy_(0, self.i, cur[:, 0][None])
        self.i.add_(1)


class AudioCachingSampler:
    """
    :param n_steps: diffusion steps per token
    :param num_tokens: new tokens to generate
    :param noise_prev: noise level the cached history is held at
    :param custom_schedule: optional explicit schedule (e.g. [1.0, 0.5])
    :param max_window: rolling context bound in tokens (ring capacity)
    :param fused_write: fold each token's ring write into the next token's
        first forward
    """

    def __init__(self, n_steps: int = 16, num_tokens: int = 120,
                 noise_prev: float = 0.2, custom_schedule=None,
                 max_window=None, fused_write: bool = True, **_):
        self.n_steps = n_steps
        self.num_tokens = num_tokens
        self.noise_prev = noise_prev
        self.custom_schedule = (list(custom_schedule)
                                if custom_schedule is not None else None)
        self.max_window = max_window
        self.fused_write = fused_write
        self.schedule = resolve_schedule(n_steps, self.custom_schedule)
        self._loops = {}

    def __call__(self, core, x, generator: Optional[torch.Generator] = None,
                 noise: Optional[SamplerNoise] = None, decode_fn=None,
                 vae_scale: float = 1.0):
        """core: AudioRFTCore; x: [b, init_len, c] context latents ->
        [b, min(init_len, window) + num_tokens, c] latents (and the
        decoded waveforms with ``decode_fn``). On a CUDA device the tokens
        come from CUDA-graph replays of one token's step."""
        latents = self._sample(core, x, generator, noise, graphed=x.is_cuda)
        if decode_fn is not None:
            return latents, decode_fn(latents * vae_scale)
        return latents

    def sample_eager(self, core, x,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[SamplerNoise] = None):
        """The same generation with every step run eagerly: the reference
        that the CUDA-graph replays are held to on the card."""
        return self._sample(core, x, generator, noise, graphed=False)

    def window(self, x):
        """(x cut to its trailing window, ring capacity in tokens)."""
        capacity = self.max_window or (x.shape[1] + self.num_tokens)
        return x[:, -capacity:], capacity

    def prepare(self, core, x, noise: SamplerNoise) -> TokenLoop:
        """The loop of this (core, shape), reset to a new run: draws
        copied in, the context written into the ring at ``noise_prev``
        (with ``fused_write`` all but its last token, which becomes the
        pending write); ``x`` is cut to its window first."""
        x, capacity = self.window(x)
        b, init_len, c = x.shape
        n = self.num_tokens
        check_noise(noise, ctx=(b, init_len, c), init=(n, b, 1, c),
                    renoise=(n, b, 1, c))
        key = (id(core), b, c, capacity, x.dtype, str(x.device))
        if key not in self._loops:
            self._loops[key] = (core, TokenLoop(self, core.config, b, c,
                                                capacity, x.dtype, x.device))
        loop = self._loops[key][1]
        loop.cache.reset()
        loop.i.zero_()
        loop.init.copy_(noise.init)
        loop.renoise.copy_(noise.renoise)

        a = self.noise_prev
        noisy_ctx = zlerp(x, a, z=noise.ctx)
        t_ctx = torch.full((b, init_len), a, dtype=x.dtype, device=x.device)
        if self.fused_write:
            if init_len > 1:
                core(noisy_ctx[:, :-1], t_ctx[:, :-1], kv_cache=loop.cache,
                     write=True)
            loop.pending.copy_(noisy_ctx[:, -1:])
        else:
            core(noisy_ctx, t_ctx, kv_cache=loop.cache, write=True)
        return loop

    @torch.no_grad()
    def _sample(self, core, x, generator, noise, graphed: bool):
        x, capacity = self.window(x)
        b, init_len, c = x.shape
        if noise is None:
            noise = draw_noise(generator, b, init_len, c, self.num_tokens,
                               x.device)
        loop = self.prepare(core, x, noise)
        # sessions longer than the RoPE table: segments with an exact ring
        # rebase between them (one segment, no rebase, in the common case)
        table_f, delta_f, rebase = rope_rebase_plan(core.config, capacity)
        segs = rope_rebase_segments(init_len, self.num_tokens, table_f,
                                    delta_f)
        for si, seg in enumerate(segs):
            if si:
                rebase(loop.cache)
            loop.run(core, seg, graphed)
        return torch.cat([x, loop.tokens.transpose(0, 1)], dim=1)
