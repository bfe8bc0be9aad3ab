"""Shared helpers of the tests/test_torch_port_*.py files, which hold the
PyTorch port (owl_audio_exps_tpu_torch) against the JAX package on the
CPU: inputs are made with numpy from a seed and handed to both."""

from __future__ import annotations

import jax
import numpy as np
import torch

from owl_audio_exps_tpu.configs import transformer_config as jax_config
from owl_audio_exps_tpu_torch.configs import transformer_config as port_config
from owl_audio_exps_tpu_torch.utils.weights import params_from_jax

TINY_AV = dict(
    model_id="game_rft_audio", n_layers=2, n_heads=2, d_model=32,
    channels=4, audio_channels=4, sample_size=2, tokens_per_frame=5,
    n_frames=8, n_buttons=11, uncond=False, has_audio=True,
    rope_impl="ortho", local_window=2, global_window=None, cfg_prob=0.0)


def configs(**overrides):
    """(JAX config, port config) with the same keys."""
    kw = dict(TINY_AV, **overrides)
    return jax_config(**kw), port_config(**kw)


def numpy_params(params):
    return jax.tree.map(np.asarray, params)


def load_jax_params(module: torch.nn.Module, params, n_heads: int):
    """Load JAX params into a port module; every key must match."""
    module.load_state_dict(params_from_jax(numpy_params(params), n_heads),
                           strict=True)
    return module


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------------
# The band2 kernel's walk (owl_audio_exps_tpu_torch/csrc/attention_tiles.cuh
# plan_kv_range, plan_q_range, cut_skip_tiles, tile_full; 64-row tiles),
# written again in Python so the CPU tests can hold it to the dense mask.
# A model of the kernel's arithmetic, not a measurement of it.

WALK_TILE = 64
SKIP, FULL, PARTIAL = 0, 1, 2


def tile_class(r0: int, r1: int, c0: int, c1: int, n_tokens: int,
               tokens_per_frame: int, window: int) -> int:
    """Class of query rows [r0, r1) against key rows [c0, c1), global
    token indices, under the causal frame window. Rows and keys at or
    past L are invisible."""
    re, ce = min(r1, n_tokens), min(c1, n_tokens)
    if re <= r0 or ce <= c0:
        return SKIP
    tpf = tokens_per_frame
    lo = r0 // tpf - (ce - 1) // tpf
    hi = (re - 1) // tpf - c0 // tpf
    if hi < 0 or lo > window - 1:
        return SKIP
    if lo >= 0 and hi <= window - 1 and r1 <= n_tokens and c1 <= n_tokens:
        return FULL
    return PARTIAL


def _cut_skip_tiles(lo: int, hi: int, begin: int, end: int):
    """Cut a walk's SKIP tiles, all before or after the rows [lo, hi) the
    tile at hand can see."""
    if lo > begin:
        begin += (lo - begin) // WALK_TILE * WALK_TILE
    return begin, min(end, hi)


def plan_kv_range(n_tokens: int, tokens_per_frame: int, window: int,
                  span: int, nrefs: int, next_cols: int, q0: int):
    """Key rows [begin, end) the kernel walks for the query tile at q0:
    the plan's chunks, without the SKIP tiles."""
    tpf, last = tokens_per_frame, min(q0 + WALK_TILE, n_tokens) - 1
    nc = n_tokens // span
    i_lo, i_hi = q0 // span, last // span
    begin = max(0, (i_lo - nrefs) * span)
    end = min(n_tokens, (i_hi + 1) * span
              + (next_cols if i_hi + 1 < nc else 0))
    return _cut_skip_tiles(max(0, q0 // tpf - window + 1) * tpf,
                           min(n_tokens, (last // tpf + 1) * tpf),
                           begin, end)


def plan_q_range(n_tokens: int, tokens_per_frame: int, window: int,
                 span: int, nrefs: int, next_cols: int, k0: int):
    """Query rows [begin, end) the kernel walks for the key tile at k0:
    the chunks whose plan reads it, without the SKIP tiles."""
    tpf, last = tokens_per_frame, min(k0 + WALK_TILE, n_tokens) - 1
    t_lo, t_hi = k0 // span, last // span
    first = t_lo - 1 if k0 - t_lo * span < next_cols else t_lo
    begin = max(0, first * span)
    end = min(n_tokens, (t_hi + nrefs + 1) * span)
    return _cut_skip_tiles(k0 // tpf * tpf,
                           min(n_tokens, (last // tpf + window) * tpf),
                           begin, end)


def kernel_tiles(n_tokens: int, tokens_per_frame: int, window: int,
                 span: int, nrefs: int, next_cols: int) -> dict:
    """Tiles of one head that the forward (or dq) blocks ("q") and the
    dk/dv blocks ("kv") walk, by class, as the model counts them."""
    out = {}
    for role, rng in (("q", plan_kv_range), ("kv", plan_q_range)):
        counts = [0, 0, 0]
        for t0 in range(0, n_tokens, WALK_TILE):
            begin, end = rng(n_tokens, tokens_per_frame, window, span,
                             nrefs, next_cols, t0)
            for o0 in range(begin, end, WALK_TILE):
                r0, c0 = (t0, o0) if role == "q" else (o0, t0)
                counts[tile_class(r0, r0 + WALK_TILE, c0, c0 + WALK_TILE,
                                  n_tokens, tokens_per_frame, window)] += 1
        out[role] = dict(zip(("skip", "full", "partial"), counts))
    return out


def av_inputs(rs: np.random.RandomState, b: int, n: int, cfg, dtype=np.float32):
    """(x, audio, t, mouse, btn) numpy inputs of the AV core."""
    p = cfg.sample_size
    return (rs.randn(b, n, cfg.channels, p, p).astype(dtype),
            rs.randn(b, n, cfg.audio_channels).astype(dtype),
            rs.rand(b, n).astype(dtype),
            rs.randn(b, n, 2).astype(dtype),
            (rs.rand(b, n, cfg.n_buttons) > 0.5).astype(dtype))
