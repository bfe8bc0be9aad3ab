"""The port's KV-cached serve pipelines (inference/pipeline.py
``CachedStreamingPipeline``, ``AVCachedStreamingPipeline``) and
``CausvidPipeline.load_cache`` against the JAX package's
(inference/pipeline.py), on the CPU.

Both sides run the same float32 core (JAX params carried across with
``params_from_jax``) and the JAX pipeline's own draws: before each call
the test reads the JAX pipeline's key and derives the draws in its split
order (``prime``: the context's draw; a tick: each stream's initial and
re-noise draw), which the port takes as arguments. The pipelines keep
latents, controls and rings in bfloat16 (the JAX pipeline hard-codes it),
so the two sides round at the same points, and a float32 difference in
between can move a value across a bfloat16 rounding boundary. Tolerance:
every tick's frame (and audio latent) and the ring contents after
``prime`` and after every tick within 1 bfloat16 rounding step of the
value (rtol 2^-7) plus atol 1e-3; the ring counters and the host's RoPE
offset exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_audio_exps_tpu_torch.inference.pipeline import (
    AVCachedStreamingPipeline, CachedStreamingPipeline, CausvidPipeline,
    TickNoise)

from torch_port_util import (COUNTERS, RINGS, av_cores, jax_serve_pipelines,
                             t, video_cores)

RTOL, ATOL = 2.0 ** -7, 1e-3
F32 = jnp.float32


def close(got, want, what):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def same_ring(jc, pc, what):
    for name in COUNTERS:
        a, b = getattr(jc, name), getattr(pc, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert int(a) == int(b), f"{what}: {name}"
    for name in RINGS:
        a, b = getattr(jc, name), getattr(pc, name)
        assert (a is None) == (b is None), name
        if a is not None:
            close(b, a, f"{what}: ring {name}")


class Draws:
    """The JAX pipeline's next draws, read off its key (its split order:
    prime split(rng, 1 + streams), a tick split(rng, 1 + 2 streams))."""

    def __init__(self, jpipe, items):
        self.jp, self.items = jpipe, items

    def prime(self, lat_shapes):
        keys = jax.random.split(self.jp.rng, 1 + len(lat_shapes))[1:]
        return tuple(t(np.asarray(jax.random.normal(k, s, F32)))
                     for k, s in zip(keys, lat_shapes))

    def tick(self, B):
        n = len(self.items)
        keys = jax.random.split(self.jp.rng, 1 + 2 * n)[1:]
        z = [t(np.asarray(jax.random.normal(k, (B, 1) + it, F32)))
             for k, it in zip(keys, self.items + self.items)]
        if n == 1:   # video: (rng, r_init, r_renoise)
            return TickNoise((z[0],), (z[1],))
        # AV: (rng, r_v, r_a, r_nv, r_na)
        return TickNoise(tuple(z[:n]), tuple(z[n:]))


def _cases():
    """(config overrides, pipeline kwargs, sessions, prime frames, ticks) by
    case: each tick mode with one session (2 steps, the [1.0, 0.5]
    schedule) and with two (3 steps, the SD3 schedule), and a session
    whose next frame leaves the 16-frame RoPE table, so that the ring is
    rebased between ticks."""
    modes = {"steady": (3, {}), "first_unprimed": (0, {}),
             "plain": (3, dict(fused_write=False))}
    cases = {}
    for mode, (n_prime, kw) in modes.items():
        for B, steps in ((1, 2), (2, 3)):
            cases[f"{mode}_{B}"] = ({}, dict(kw, window_frames=6,
                                             sampling_steps=steps,
                                             n_sessions=B), B, n_prime, 8)
    cases["crosses_rope_rebases_1"] = (
        dict(n_frames=8, rope_headroom=8),
        dict(window_frames=6, sampling_steps=2), 1, 3, 24)
    return cases


CASES = _cases()


def _run(kind, case, **model):
    """Both pipelines through ``case``, tick against tick and ring against
    ring; ``model`` overrides the core's config (e.g. the backbone)."""
    over, pkw, B, n_prime, n_ticks = CASES[case]
    over = dict(over, **model)
    if kind == "video":
        jcfg, pcfg, jcore, params, port = video_cores(**over)
        jcls, pcls = "CachedStreamingPipeline", CachedStreamingPipeline
        items = [(4, 2, 2)]
    else:
        jcfg, pcfg, jcore, params, port = av_cores(**over)
        jcls, pcls = "AVCachedStreamingPipeline", AVCachedStreamingPipeline
        items = [(4, 2, 2), (4,)]
    jp = getattr(jax_serve_pipelines(), jcls)(jcore, params, jcfg, seed=11,
                                              **pkw)
    pp = pcls(port, pcfg, device="cpu", **pkw)
    draws = Draws(jp, items)
    rs = np.random.RandomState(3)
    if n_prime:
        lats = [rs.randn(B, n_prime, *it).astype(np.float32) for it in items]
        m = rs.randn(B, n_prime, 2).astype(np.float32)
        b = (rs.rand(B, n_prime, 3) > 0.5).astype(np.float32)
        noise = draws.prime([x.shape for x in lats])
        jp.prime(*(jnp.asarray(x) for x in lats), jnp.asarray(m),
                 jnp.asarray(b))
        pp.prime(*(t(x) for x in lats), t(m), t(b),
                 noise=noise if kind == "av" else noise[0])
        same_ring(jp.cache, pp.cache, "after prime")
    rebases = 0
    for i in range(n_ticks):
        mouse = rs.randn(B, 2).astype(np.float32)
        btn = (rs.rand(B, 3) > 0.5).astype(np.float32)
        if B == 1:   # one session's controls arrive without a batch axis
            mouse, btn = mouse[0], btn[0]
        noise = draws.tick(B)
        off = pp._off_frames
        want = jp(mouse, btn)
        got = pp(mouse, btn, noise=noise)
        rebases += pp._off_frames < off
        assert pp._off_frames == jp._off_frames
        close(got[0], want[0], f"tick {i} frame")
        if kind == "av":
            close(got[1], want[1], f"tick {i} audio")
        else:
            assert got[1] is None and want[1] is None
        assert tuple(got[0].shape) == (B, 4, 2, 2)
        same_ring(jp.cache, pp.cache, f"after tick {i}")
    assert pp.has_pending == pp.fused_write == (jp._pending is not None)
    return pp, rebases


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", ["video", "av"])
def test_cached_pipeline_matches_jax(kind, case):
    pp, rebases = _run(kind, case)
    assert (rebases > 0) == case.startswith("crosses_rope_rebases")
    _, pkw, _, n_prime, n_ticks = CASES[case]
    # a fused session's newest frame pends, uncommitted
    committed = n_prime + n_ticks - pp.fused_write
    assert int(pp.cache.length) == \
        min(committed, 6) * pp.config.tokens_per_frame


def test_sessions_tick_in_lockstep_and_stay_apart():
    """Session 0's frames do not depend on session 1's controls
    (tests/test_inference.py's multi-session contract), on the port's own
    draws."""
    _, pcfg, _, _, port = av_cores()
    rs = np.random.RandomState(0)
    m0 = rs.randn(5, 2).astype(np.float32)
    b0 = (rs.rand(5, 3) > 0.5).astype(np.float32)
    x = torch.from_numpy(rs.randn(1, 3, 4, 2, 2).astype(np.float32))
    a = torch.from_numpy(rs.randn(1, 3, 4).astype(np.float32))

    def run(scale):
        pipe = AVCachedStreamingPipeline(port, pcfg, window_frames=6,
                                         sampling_steps=2, n_sessions=2,
                                         seed=7, device="cpu")
        pipe.prime(x.expand(2, -1, -1, -1, -1), a.expand(2, -1, -1),
                   torch.zeros(2, 3, 2), torch.zeros(2, 3, 3))
        out = []
        for i in range(5):
            f, au, _ = pipe(np.stack([m0[i], m0[i] * scale]),
                            np.stack([b0[i], 1.0 - b0[i]]))
            assert f.shape == (2, 4, 2, 2) and au.shape == (2, 4)
            out.append((f, au))
        return out

    ra, rb = run(1.0), run(-3.0)
    for (fa, aa), (fb, ab) in zip(ra, rb):
        assert torch.equal(fa[0], fb[0]) and torch.equal(aa[0], ab[0])
    assert any(not torch.equal(fb[0], fb[1]) for fb, _ in rb)


def test_pipelines_decode_and_take_the_generator():
    """Decoders see the latents times their scales; the generator's draws
    are reproducible per seed."""
    _, pcfg, _, _, port = av_cores()
    runs = []
    for _ in range(2):
        pipe = AVCachedStreamingPipeline(
            port, pcfg, window_frames=4, sampling_steps=1, seed=3,
            device="cpu", frame_decode_fn=lambda z: z.sum(2),
            image_scale=2.0, audio_decode_fn=lambda z: z * 0 + 1,
            audio_scale=3.0)
        runs.append([pipe(np.zeros(2), np.zeros(3)) for _ in range(3)])
    for (f0, a0, dt0), (f1, a1, _) in zip(*runs):
        assert f0.shape == (1, 2, 2) and a0.shape == (1, 1, 4)
        assert torch.equal(f0, f1) and dt0 > 0
    vpipe = CachedStreamingPipeline(video_cores()[-1], video_cores()[1],
                                    window_frames=4, device="cpu",
                                    n_sessions=2)
    frame, audio, _ = vpipe(np.zeros((2, 2)), np.zeros((2, 3)))
    assert frame.shape == (2, 4, 2, 2) and audio is None


def test_causvid_load_cache(tmp_path):
    """``load_cache`` reads buffers_{idx}.npz and divides the latents by
    their scales, as the JAX pipeline does (JAX and port read the same
    file)."""
    _, pcfg, _, params, port = av_cores(causal=True)
    rs = np.random.RandomState(1)
    W = 4
    data = dict(history=rs.randn(1, W, 4, 2, 2).astype(np.float32),
                audio=rs.randn(1, W, 4).astype(np.float32),
                mouse=rs.randn(1, W, 2).astype(np.float32),
                button=(rs.rand(1, W, 3) > 0.5).astype(np.float32))
    np.savez(tmp_path / "buffers_5.npz", **data)
    jmod = jax_serve_pipelines()
    jcfg, _, jcore, _, _ = av_cores(causal=True)
    jp = jmod.CausvidPipeline(jcore, params, jcfg, image_scale=2.0,
                              audio_scale=4.0, window_length=W)
    pp = CausvidPipeline(port, pcfg, image_scale=2.0, audio_scale=4.0,
                         window_length=W, device="cpu")
    jp.load_cache(str(tmp_path), 5)
    pp.load_cache(str(tmp_path), 5)
    for name in ("history", "audio", "mouse", "button"):
        got = getattr(pp.buffers, name)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got.float().numpy(),
            np.asarray(getattr(jp.buffers, name), np.float32), err_msg=name)
    frame, audio, _ = pp(np.zeros(2), np.zeros(3))
    assert torch.isfinite(frame.float()).all()
    pp.restart_from_buffer()
    torch.testing.assert_close(pp.buffers.history,
                               t(data["history"] / 2.0).to(torch.bfloat16))
