"""The port's KV-cached video samplers (sampling/av_caching.py:
``AVCachingSamplerV2``, ``AVCachingSampler``, ``AVCachingOneStepSampler``)
and the cache plumbing of both cores (models/gamerft.py,
models/gamerft_audio.py: ``write``, ``decoding``, ``write_len`` in
frames) against the JAX package, on the CPU in float32.

JAX params are carried across with ``params_from_jax``; inputs are numpy
from a seed; the samplers' draws are made with ``jax.random`` in the JAX
sampler's split order and handed to the port (``SamplerNoise``).
Tolerances: forwards atol 1e-4; the ring state after each forward with
counters exact and contents within 1e-5 (rotated keys of magnitude up to
~3, a few float32 ulps); a whole sampler run max |diff| 1e-3 over every
generated frame (the audio sampler's bound, tests/test_torch_port_audio.py).
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_audio_exps_tpu.nn.kv_cache import KVCache as JaxKVCache
from owl_audio_exps_tpu.sampling import get_sampler_cls as jax_sampler_cls
from owl_audio_exps_tpu_torch.nn.kv_cache import KVCache
from owl_audio_exps_tpu_torch.sampling import get_sampler_cls
from owl_audio_exps_tpu_torch.sampling.av_caching import (
    AVCachingOneStepSampler, AVCachingSampler, AVCachingSamplerV2)
from owl_audio_exps_tpu_torch.sampling.common import SamplerNoise

from torch_port_util import (assert_same_state, av_cores,
                             jax_sampler_draws, t, video_cores, video_inputs)

F32 = jnp.float32
ATOL = 1e-4
RING_ATOL = 1e-5
SAMPLER_ATOL = 1e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# ---------------------------------------------------------------- forwards

def _check_cached_forwards(jcfg, pcfg, jcore, params, port, arrays, b,
                           capacity, n_frames):
    """A prefill, fused 2-frame forwards committing one frame (past the
    ring's wrap), decoding forwards, cached forwards that do not write,
    and an unfused decoding write, each against JAX ``core.apply`` from
    the same cache state: velocities and the ring state."""
    jc = JaxKVCache.from_config(jcfg, b, capacity_frames=capacity, dtype=F32)
    pc = KVCache.from_config(pcfg, b, capacity_frames=capacity,
                             dtype=torch.float32, device="cpu")
    apply = jax.jit(jcore.apply,
                    static_argnames=("write", "decoding", "write_len"))

    def both(sl, **kw):
        nonlocal jc
        args = [a[:, sl] for a in arrays]
        want, new = apply(params, *(jnp.asarray(a) for a in args),
                          kv_cache=jc, **kw)
        with torch.no_grad():
            got = port(*(t(a) for a in args), kv_cache=pc, **kw)
        for g, w in zip(*(v if isinstance(v, tuple) else (v,)
                          for v in (got, want))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                       rtol=0)
        if kw.get("write"):
            jc = new
        assert_same_state(jc, pc, atol=RING_ATOL)

    both(slice(0, 4), write=True)
    for i in range(4, n_frames - 2):
        both(slice(i, i + 2), write=True, write_len=1)
        both(slice(i + 1, i + 2), decoding=True)
        both(slice(i + 1, i + 2))
    both(slice(n_frames - 2, n_frames - 1), write=True, decoding=True)
    assert int(pc.length) == capacity * pcfg.tokens_per_frame
    assert int(pc.rope_offset) == (n_frames - 1) * pcfg.tokens_per_frame
    return pc


@pytest.mark.parametrize("split", ["auto", False])
def test_video_core_cached_forwards_match_jax(split):
    jcfg, pcfg, jcore, params, port = video_cores(split_local_cache=split)
    x, m, b = video_inputs(1, 2, 10, 10)
    ts = np.random.RandomState(2).rand(2, 10).astype(np.float32)
    pc = _check_cached_forwards(jcfg, pcfg, jcore, params, port,
                                (x, ts, m, b), 2, 6, 10)
    assert pc.split == (split == "auto")


def test_av_core_cached_forwards_match_jax():
    """The AV core writes each frame's 4 video tokens and then its audio
    token into the ring in stream order, as the JAX core does."""
    jcfg, pcfg, jcore, params, port = av_cores()
    rs = np.random.RandomState(3)
    arrays = (rs.randn(1, 10, 4, 2, 2).astype(np.float32),
              rs.randn(1, 10, 4).astype(np.float32),
              rs.rand(1, 10).astype(np.float32),
              rs.randn(1, 10, 2).astype(np.float32),
              (rs.rand(1, 10, 3) > 0.5).astype(np.float32))
    _check_cached_forwards(jcfg, pcfg, jcore, params, port, arrays, 1, 6, 10)


@pytest.mark.parametrize("kind", ["video", "av"])
def test_cached_decode_matches_the_full_forward(kind):
    """Prefill n - 1 frames, then decode the last one: equal to the last
    frame of one uncached causal forward (tests/test_models.py)."""
    over = dict(n_frames=16)
    _, pcfg, _, _, port = (video_cores if kind == "video" else av_cores)(
        **over)
    rs = np.random.RandomState(4)
    x = t(rs.randn(2, 6, 4, 2, 2).astype(np.float32))
    a = t(rs.randn(2, 6, 4).astype(np.float32))
    ts = t(rs.rand(2, 6).astype(np.float32))
    m = t(rs.randn(2, 6, 2).astype(np.float32))
    b = t((rs.rand(2, 6, 3) > 0.5).astype(np.float32))
    lat = (x,) if kind == "video" else (x, a)

    def run(sl, **kw):
        out = port(*(v[:, sl] for v in lat), ts[:, sl], m[:, sl], b[:, sl],
                   **kw)
        return out if isinstance(out, tuple) else (out,)

    with torch.no_grad():
        full = run(slice(0, 6))
        for decoding in (False, True):
            cache = KVCache.from_config(pcfg, 2, capacity_frames=8,
                                        dtype=torch.float32, device="cpu")
            run(slice(0, 5), kv_cache=cache, write=True)
            last = run(slice(5, 6), kv_cache=cache, decoding=decoding)
            for got, want in zip(last, full):
                torch.testing.assert_close(got[:, 0], want[:, -1], atol=2e-4,
                                           rtol=0)


# ---------------------------------------------------------------- samplers

def _port_noise(key, x_cut_shape, num):
    ctx, init, renoise = jax_sampler_draws(key, x_cut_shape,
                                           x_cut_shape[2:], num)
    return SamplerNoise(t(ctx), t(init), t(renoise))


def _run_both(sampler_id, over, skw, b=1, n_ctx=4, n_ctrl=10, seed=0):
    """(JAX output, port output, port sampler, inputs, noise) of one run
    of the same sampler on the same weights, inputs and draws."""
    _, _, jcore, params, port = video_cores(**over)
    x, m, btn = video_inputs(seed, b, n_ctx, n_ctrl)
    key = jax.random.key(7)
    want = jax_sampler_cls(sampler_id)(**skw)(
        jcore, params, jnp.asarray(x), jnp.asarray(m), jnp.asarray(btn), key)
    sampler = get_sampler_cls(sampler_id)(**skw)
    n = sampler.frames_to_generate(t(x), t(m))
    x_cut, _ = sampler.window(t(x), n)
    noise = _port_noise(key, tuple(x_cut.shape), n)
    got = sampler(port, t(x), t(m), t(btn), noise=noise)
    return np.asarray(want), got, sampler, port, (x, m, btn), noise


SAMPLER_CASES = {
    # (config overrides, sampler kwargs, batch, context frames, controls)
    "fused_cfg": ({}, dict(n_steps=2, cfg_scale=1.3, num_frames=6), 1, 4,
                  10),
    "unfused_cfg": ({}, dict(n_steps=2, cfg_scale=1.3, num_frames=6,
                             fused_write=False), 1, 4, 10),
    "custom_schedule_batch_2": (
        {}, dict(n_steps=2, cfg_scale=1.0, num_frames=6,
                 custom_schedule=[1.0, 0.5]), 2, 4, 10),
    "rolling_window_evicts": (
        {}, dict(n_steps=2, cfg_scale=1.3, num_frames=12, max_window=5), 1,
        4, 16),
    # a window shorter than the context cuts it; the controls are indexed
    # from the cut context's length, as in the JAX sampler
    "window_cuts_the_context": (
        dict(split_local_cache=False),
        dict(n_steps=3, cfg_scale=1.0, num_frames=6, max_window=3,
             fused_write=False), 1, 4, 10),
    "chunked_prefill": ({}, dict(n_steps=2, cfg_scale=1.3, num_frames=6,
                                 chunked_prefill=True), 1, 4, 10),
    "init_len_1_only_generated": (
        {}, dict(n_steps=3, cfg_scale=1.3, num_frames=10,
                 only_return_generated=True), 1, 1, 11),
    "outlives_the_rope_table": (
        dict(n_frames=8, rope_headroom=8),
        dict(n_steps=2, cfg_scale=1.3, num_frames=20,
             custom_schedule=[1.0, 0.5], max_window=6), 1, 4, 24),
}


@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_av_caching_v2_matches_jax(case):
    over, skw, b, n_ctx, n_ctrl = SAMPLER_CASES[case]
    want, got, sampler, port, inputs, noise = _run_both(
        "av_caching", over, skw, b, n_ctx, n_ctrl)
    assert isinstance(sampler, AVCachingSamplerV2)
    assert tuple(got.shape) == want.shape
    assert skw["num_frames"] >= 6
    np.testing.assert_allclose(got.numpy(), want, atol=SAMPLER_ATOL, rtol=0)
    # a second call reuses the loop's buffers and gives the same frames
    x, m, btn = (t(a) for a in inputs)
    torch.testing.assert_close(sampler(port, x, m, btn, noise=noise), got,
                               atol=0, rtol=0)
    if skw.get("chunked_prefill"):
        oneshot = AVCachingSamplerV2(**dict(skw, chunked_prefill=False))
        torch.testing.assert_close(oneshot(port, x, m, btn, noise=noise),
                                   got, atol=2e-5, rtol=2e-5)


def test_av_caching_v1_matches_jax():
    want, got, sampler, *_ = _run_both(
        "av_caching_v1", {}, dict(n_steps=3, num_frames=6))
    assert isinstance(sampler, AVCachingSampler)
    assert not sampler.fused_write and sampler.cfg_scale == 1.0
    np.testing.assert_allclose(got.numpy(), want, atol=SAMPLER_ATOL, rtol=0)
    with pytest.raises(ValueError, match="cfg_scale 1.0"):
        AVCachingSampler(cfg_scale=1.3)


def test_av_caching_one_step_matches_jax():
    want, got, sampler, *_ = _run_both(
        "av_caching_one_step", {}, dict(num_frames=6), n_ctrl=10)
    assert isinstance(sampler, AVCachingOneStepSampler)
    assert list(sampler.schedule) == [1.0] and sampler.cfg_scale == 1.0
    assert got.shape == (1, 10, 4, 2, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=SAMPLER_ATOL, rtol=0)


def test_loop_modes_draws_and_noise_checks():
    """The JAX loop modes ("scan", "host") give one output, as in
    tests/test_sampling.py; draws come from the generator reproducibly;
    draws of the wrong shape raise."""
    _, _, _, _, port = video_cores()
    x, m, btn = (t(a) for a in video_inputs(5, 1, 4, 10))
    kw = dict(n_steps=2, cfg_scale=1.3, num_frames=6, max_window=5)
    outs = [AVCachingSamplerV2(loop_mode=mode, **kw)(
        port, x, m, btn, generator=torch.Generator().manual_seed(3))
        for mode in ("scan", "host", "auto")]
    for out in outs[1:]:
        torch.testing.assert_close(out, outs[0], atol=0, rtol=0)
    sampler = AVCachingSamplerV2(**kw)
    eager = sampler.sample_eager(port, x, m, btn,
                                 generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(eager, outs[0], atol=0, rtol=0)
    other = sampler(port, x, m, btn,
                    generator=torch.Generator().manual_seed(4))
    assert not torch.equal(other, outs[0])
    with pytest.raises(ValueError, match="loop_mode"):
        AVCachingSamplerV2(loop_mode="device")
    with pytest.raises(ValueError, match="noise.init"):
        sampler(port, x, m, btn, noise=SamplerNoise(
            torch.zeros(1, 4, 4, 2, 2), torch.zeros(5, 1, 1, 4, 2, 2),
            torch.zeros(6, 1, 1, 4, 2, 2)))


def _jax_sampler_ids():
    """Every sampler id the JAX registry maps (string literals compared
    in owl_audio_exps_tpu/sampling/__init__.py)."""
    path = os.path.join(REPO, "owl_audio_exps_tpu", "sampling", "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    ids = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Compare):
            for c in ast.walk(node):
                if isinstance(c, ast.Constant) and isinstance(c.value, str):
                    ids.add(c.value)
    return sorted(ids)


def test_registry_resolves_every_jax_sampler_id():
    ids = _jax_sampler_ids()
    assert len(ids) == 8 and "av_caching" in ids
    for sid in ids:
        assert get_sampler_cls(sid).__name__ == \
            jax_sampler_cls(sid).__name__, sid
    with pytest.raises(ValueError, match="Invalid sampler id"):
        get_sampler_cls("nope")
