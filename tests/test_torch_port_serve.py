"""The port's window-recompute serve path against the JAX package.

``AVWindowSampler._denoise_frame`` and ``CausvidPipeline._denoise_window``
are deterministic given their window: each is held against the JAX code
it ports (sampling/av_window.py ``_denoise_frame``; the Euler loop of
inference/pipeline.py ``CausvidPipeline._make_tick``) with JAX params
carried over by ``params_from_jax``, in float32. Tolerance: atol 1e-4
after 2-3 denoise steps. The random parts (re-noising, control
permutation) draw from a ``torch.Generator`` and are checked for shape,
finiteness and determinism, as tests/test_inference.py does for JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_audio_exps_tpu.models.gamerft_audio import (
    GameRFTAudioCore as JaxCore)
from owl_audio_exps_tpu.sampling import schedulers as jsched
from owl_audio_exps_tpu.sampling.av_window import (
    AVWindowSampler as JaxWindowSampler)
from owl_audio_exps_tpu_torch.inference.pipeline import CausvidPipeline
from owl_audio_exps_tpu_torch.models.gamerft_audio import GameRFTAudioCore
from owl_audio_exps_tpu_torch.ops import splash
from owl_audio_exps_tpu_torch.sampling import get_sampler_cls
from owl_audio_exps_tpu_torch.sampling import schedulers as psched
from owl_audio_exps_tpu_torch.sampling.av_window import AVWindowSampler
from owl_audio_exps_tpu_torch.sampling.common import zlerp
from owl_audio_exps_tpu_torch.utils.controls import batch_permute_to_length

from torch_port_util import av_inputs, configs, load_jax_params, t

ATOL = 1e-4


def _cores(jcfg, pcfg, inputs):
    jcore = JaxCore(jcfg, dtype=jnp.float32)
    params = jax.jit(jcore.init)(jax.random.key(0),
                                 *(jnp.asarray(a) for a in inputs))
    port = GameRFTAudioCore(pcfg, dtype=torch.float32, device="cpu",
                            seed=None)
    return jcore, params, load_jax_params(port, params, pcfg.n_heads)


@pytest.mark.parametrize("attn_impl", ["auto", "splash"])
def test_denoise_frame_matches_jax(attn_impl):
    jcfg, pcfg = configs(causal=False, local_window=3)
    pcfg.attn_impl = attn_impl
    W = 4
    x, a, _, m, b = av_inputs(np.random.RandomState(0), 2, W, jcfg)
    wt = np.full((2, W), 0.2, np.float32)
    wt[:, -1] = 1.0
    jcore, params, port = _cores(jcfg, pcfg, (x, a, wt, m, b))
    dt = jsched.resolve_schedule(3, None)
    kw = dict(n_steps=3, cfg_scale=1.3, window_length=W, num_frames=1)
    ref_x, ref_a = jax.jit(
        lambda p, *arr: JaxWindowSampler(**kw)._denoise_frame(
            jcore, p, *arr, dt, jax.random.key(1)))(
        params, *(jnp.asarray(v) for v in (x, a, wt, m, b)))
    got_x, got_a = AVWindowSampler(**kw)._denoise_frame(
        port, t(x), t(a), t(wt), t(m), t(b), dt)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(ref_x), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(ref_a), atol=ATOL,
                               rtol=0)


def test_denoise_window_matches_jax_euler_loop():
    jcfg, pcfg = configs(causal=True)
    W, n_steps = 4, 2
    x, a, _, m, b = av_inputs(np.random.RandomState(1), 1, W, jcfg)
    ts = np.full((1, W), 0.2, np.float32)
    ts[:, -1] = 1.0
    jcore, params, port = _cores(jcfg, pcfg, (x, a, ts, m, b))

    # inference/pipeline.py CausvidPipeline._make_tick, the scanned step
    dt = 1.0 / n_steps

    def step(state, _):
        x, a, ts = state
        (pv, pa), _ = jcore.apply(params, x, a, ts, jnp.asarray(m),
                                  jnp.asarray(b))
        x = x.at[:, -1].set(
            (x[:, -1].astype(jnp.float32)
             - dt * pv[:, -1].astype(jnp.float32)).astype(x.dtype))
        a = a.at[:, -1].set(
            (a[:, -1].astype(jnp.float32)
             - dt * pa[:, -1].astype(jnp.float32)).astype(a.dtype))
        ts = ts.at[:, -1].add(-dt)
        return (x, a, ts), None

    (rx, ra, rts), _ = jax.jit(lambda s: jax.lax.scan(
        step, s, None, length=n_steps))(
        (jnp.asarray(x), jnp.asarray(a), jnp.asarray(ts)))
    pipe = CausvidPipeline(port, pcfg, window_length=W, device="cpu")
    gx, ga, gts = pipe._denoise_window(t(x), t(a), t(ts), t(m), t(b),
                                       n_steps)
    for got, ref in ((gx, rx), (ga, ra), (gts, rts)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                                   rtol=0)


def test_causvid_pipeline_tick():
    """Port of tests/test_inference.py::test_causvid_pipeline_tick."""
    _, pcfg = configs(causal=True)
    core = GameRFTAudioCore(pcfg, dtype=torch.float32, device="cpu")
    W = 4
    pipe = CausvidPipeline(core, pcfg, window_length=W, sampling_steps=2,
                           device="cpu")
    before = splash.launches
    for _ in range(3):
        frame, audio, model_time = pipe(np.asarray([0.5, -0.2]),
                                        np.zeros(11))
        assert frame.shape == (1, 4, 2, 2) and audio.shape == (1, 4)
        assert frame.dtype == torch.bfloat16
        assert torch.isfinite(frame.float()).all()
        assert model_time > 0
    assert pipe.buffers.history.shape == (1, W, 4, 2, 2)
    assert float(pipe.buffers.history[:, -1].float().abs().sum()) > 0
    assert splash.launches == before

    pipe.up_sampling_steps()
    assert pipe.sampling_steps == 3
    frame, _, _ = pipe(np.zeros(2), np.zeros(11))
    assert frame.shape == (1, 4, 2, 2)
    for _ in range(5):
        pipe.down_sampling_steps()
    assert pipe.sampling_steps == 1

    pipe.restart_from_buffer()
    assert float(pipe.buffers.history.float().abs().sum()) == 0.0


def test_pipeline_is_deterministic_per_seed():
    _, pcfg = configs(causal=True)
    core = GameRFTAudioCore(pcfg, dtype=torch.float32, device="cpu")
    frames = []
    for _ in range(2):
        pipe = CausvidPipeline(core, pcfg, window_length=3, seed=5,
                               device="cpu")
        frames.append([pipe(np.ones(2), np.ones(11))[0] for _ in range(2)])
    for f0, f1 in zip(*frames):
        torch.testing.assert_close(f0, f1, atol=0, rtol=0)


@pytest.mark.parametrize("only_generated", [False, True])
def test_window_sampler_end_to_end(only_generated):
    _, pcfg = configs(causal=False, local_window=3)
    core = GameRFTAudioCore(pcfg, dtype=torch.float32, device="cpu")
    x, a, _, m, b = (t(v) for v in av_inputs(np.random.RandomState(2), 2,
                                             5, pcfg))
    sampler = get_sampler_cls("av_window")(
        n_steps=2, window_length=4, num_frames=3,
        only_return_generated=only_generated)
    gen = torch.Generator().manual_seed(0)
    dec = lambda v: v * 2  # noqa: E731
    vdec, adec, x_out, a_out, mo, bo = sampler(core, x, a, m, b,
                                               generator=gen, decode_fn=dec)
    n = 3 if only_generated else 5 + 3
    assert x_out.shape == (2, n, 4, 2, 2) and a_out.shape == (2, n, 4)
    # controls are extended to num_frames + window_length, as in JAX
    nc = 3 if only_generated else 3 + 4
    assert mo.shape == (2, nc, 2) and bo.shape == (2, nc, 11)
    assert adec is None and torch.equal(vdec, x_out * 2)
    assert torch.isfinite(x_out).all() and torch.isfinite(a_out).all()
    if not only_generated:
        torch.testing.assert_close(x_out[:, :5], x, atol=0, rtol=0)


@pytest.mark.parametrize("n_steps,custom", [
    (1, None), (2, None), (20, None), (2, [1.0, 0.5]),
    (3, [1.0, 0.75, 0.25, 0.0])])
def test_schedules_match_jax(n_steps, custom):
    np.testing.assert_array_equal(psched.resolve_schedule(n_steps, custom),
                                  jsched.resolve_schedule(n_steps, custom))


def test_control_permutation_and_zlerp():
    rs = np.random.RandomState(3)
    mouse, btn = t(rs.randn(3, 5, 2)), t(rs.rand(3, 5, 11))
    gen = torch.Generator().manual_seed(0)
    m2, b2 = batch_permute_to_length(mouse, btn, 17, gen)
    assert m2.shape == (3, 17, 2) and b2.shape == (3, 17, 11)
    torch.testing.assert_close(m2[:, :5], mouse, atol=0, rtol=0)
    # each appended block is a batch permutation of the original rows
    rows = {tuple(r.flatten().tolist()) for r in mouse}
    assert {tuple(r.flatten().tolist()) for r in m2[:, 5:10]} == rows
    x = t(rs.randn(2, 3, 4).astype(np.float32))
    torch.testing.assert_close(zlerp(x, 0.0, gen), x, atol=0, rtol=0)
    assert zlerp(x, 0.5, gen).dtype == x.dtype
