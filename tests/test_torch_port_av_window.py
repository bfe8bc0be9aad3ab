"""The port's causal AV window samplers (sampling/av_window.py
``CausalAVWindowSampler``, ``CausalAVWindowSamplerNoCFG``) against the
JAX package, on the CPU in float32.

``_denoise_frame`` is deterministic given its window: step 0 writes the
whole window into a fresh ring of capacity W, then drops the denoising
frame, one ring for the conditional pass and one for the unconditional;
later steps feed only the final frame against those rings. It is held
against the JAX code it ports (atol 1e-4, as tests/test_torch_port_serve.py
holds the window-recompute sampler's), and step 0's ring state after
``drop_newest(1)`` against the JAX ring (counters exact, contents within
1e-5). The random parts (re-noising, control permutation) draw from a
``torch.Generator`` and are checked for shape, finiteness and
determinism, as tests/test_sampling.py does for JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_audio_exps_tpu.nn.kv_cache import KVCache as JaxKVCache
from owl_audio_exps_tpu.sampling import get_sampler_cls as jax_sampler_cls
from owl_audio_exps_tpu.sampling import schedulers as jsched
from owl_audio_exps_tpu_torch.nn.kv_cache import KVCache
from owl_audio_exps_tpu_torch.sampling import get_sampler_cls
from owl_audio_exps_tpu_torch.sampling.av_window import (
    CausalAVWindowSampler, CausalAVWindowSamplerNoCFG)

from torch_port_util import (assert_same_state, av_cores, av_inputs, jax_apply,
                             t)

ATOL = 1e-4
W = 4


def _window(seed, b, cfg):
    x, a, _, m, btn = av_inputs(np.random.RandomState(seed), b, W, cfg)
    wt = np.full((b, W), 0.2, np.float32)
    wt[:, -1] = 1.0
    return x, a, wt, m, btn


@pytest.mark.parametrize("sampler_id,n_steps", [
    ("av_causal", 3), ("av_causal_no_cfg", 2), ("av_causal_one_step", 1)])
def test_causal_denoise_frame_matches_jax(sampler_id, n_steps):
    _, pcfg, jcore, params, port = av_cores()
    arrays = _window(0, 2, pcfg)
    dt = jsched.resolve_schedule(n_steps, None)
    kw = dict(n_steps=n_steps, cfg_scale=1.3, window_length=W, num_frames=1)
    ref_x, ref_a = jax.jit(
        lambda p, *arr: jax_sampler_cls(sampler_id)(**kw)._denoise_frame(
            jcore, p, *arr, dt, jax.random.key(1)))(
        params, *(jnp.asarray(v) for v in arrays))
    sampler = get_sampler_cls(sampler_id)(**kw)
    assert isinstance(sampler, CausalAVWindowSampler)
    assert sampler.use_cfg == (sampler_id == "av_causal")
    got_x, got_a = sampler._denoise_frame(port, *(t(v) for v in arrays), dt)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(ref_x), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(ref_a), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("has_controls", [True, False])
def test_step0_rings_match_jax_and_the_uncached_forward(has_controls):
    """Step 0 of either pass: the whole window through a fresh ring with
    writes on, then ``drop_newest(1)`` (the RoPE offset not rewound); its
    velocities equal one uncached forward of the window."""
    jcfg, pcfg, jcore, params, port = av_cores()
    x, a, wt, m, btn = _window(1, 2, pcfg)
    hc = np.full((2,), has_controls)
    jc = JaxKVCache.from_config(jcfg, 2, capacity_frames=W, dtype=jnp.float32)
    (jv, ja), jc = jax_apply(jcore, params, x, a, wt, m, btn,
                             has_controls=hc, kv_cache=jc, write=True)
    jc = jc.drop_newest(1)
    pc = KVCache.from_config(pcfg, 2, capacity_frames=W, dtype=torch.float32,
                             device="cpu")
    args = [t(v) for v in (x, a, wt, m, btn)]
    with torch.no_grad():
        pv, pa = port(*args, has_controls=t(hc), kv_cache=pc, write=True)
        pc.drop_newest(1)
        uv, ua = port(*args, has_controls=t(hc))
    assert_same_state(jc, pc, atol=1e-5)
    assert int(pc.length) == (W - 1) * pcfg.tokens_per_frame
    assert int(pc.rope_offset) == W * pcfg.tokens_per_frame
    for got, want, full in ((pv, jv, uv), (pa, ja, ua)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
        torch.testing.assert_close(got, full, atol=2e-5, rtol=0)


@pytest.mark.parametrize("only_generated", [False, True])
def test_causal_window_samplers_end_to_end(only_generated):
    """tests/test_sampling.py::test_causal_av_window_samplers on the port:
    every causal id, shapes, finite, reproducible from the generator."""
    _, pcfg, _, _, port = av_cores()
    x, a, _, m, btn = (t(v) for v in av_inputs(np.random.RandomState(2), 1,
                                               W, pcfg))
    for sid in ("av_causal", "av_causal_no_cfg", "av_causal_one_step"):
        sampler = get_sampler_cls(sid)(
            n_steps=2, cfg_scale=1.3, window_length=W, num_frames=2,
            noise_prev=0.2, only_return_generated=only_generated)
        runs = [sampler(port, x, a, m, btn,
                        generator=torch.Generator().manual_seed(s))
                for s in (0, 0, 1)]
        _, _, xl, al, em, eb = runs[0]
        n = 2 if only_generated else W + 2
        assert xl.shape == (1, n, 4, 2, 2) and al.shape == (1, n, 4)
        assert torch.isfinite(xl).all() and torch.isfinite(al).all()
        assert torch.equal(xl, runs[1][2]) and not torch.equal(xl, runs[2][2])
    assert CausalAVWindowSamplerNoCFG.use_cfg is False
