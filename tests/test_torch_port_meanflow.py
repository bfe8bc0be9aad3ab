"""The port's MeanFlow model (models/gamemft_audio.py, ``game_mft_audio``)
against the JAX package, on the CPU; the spec is tests/test_meanflow.py.

2 layers x d 32, float32. Weights are carried with ``params_from_jax``
(every key must match); the noise is the JAX model's own draw, taken
from its key and handed to the port. Tolerances: timesteps
atol 1e-6 (the same float32 sigmoid), losses rtol 1e-4, gradients atol
1e-5 / rtol 1e-3 (float32 reassociation through two jvps of the same
function); the port's jvp against a float64 central difference atol
2e-3 (the test says why).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_audio_exps_tpu.configs import transformer_config as jax_config
from owl_audio_exps_tpu.models.gamerft import handle_cfg as jax_handle_cfg
from owl_audio_exps_tpu.models.gamemft_audio import \
    GameMFTAudio as JaxGameMFTAudio
from owl_audio_exps_tpu.models.gamemft_audio import \
    GameMFTAudioCore as JaxGameMFTAudioCore
from owl_audio_exps_tpu_torch.configs import Config
from owl_audio_exps_tpu_torch.configs import transformer_config as port_config
from owl_audio_exps_tpu_torch.models import get_core_cls, get_model_cls
from owl_audio_exps_tpu_torch.models.gamemft_audio import (GameMFTAudio,
                                                           GameMFTAudioCore)
from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
from owl_audio_exps_tpu_torch.utils.weights import params_from_jax

from torch_port_util import (MODEL_RNGS, carried, jax_apply, jax_core,
                             numpy_params, t)

MFT = dict(model_id="game_mft_audio", n_layers=2, n_heads=2, d_model=32,
           channels=4, audio_channels=4, sample_size=2, tokens_per_frame=5,
           n_frames=8, n_buttons=3, causal=True, uncond=False,
           has_audio=True, rope_impl="ortho", local_window=2,
           global_window=None, cfg_prob=0.1, backbone="dit")
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-3


def _data(n=4, b=2):
    rs = np.random.RandomState(0)
    return (rs.randn(b, n, 4, 2, 2).astype(np.float32),
            rs.randn(b, n, 4).astype(np.float32),
            rs.randn(b, n, 2).astype(np.float32),
            (rs.rand(b, n, 3) > 0.5).astype(np.float32))


def _jax_draws(model, params, batch, key):
    """The JAX model's draws under ``key``, in its order: the noise key
    its forward takes (``make_rng("noise")``, the root scope's first)
    splits into the CFG dropout's, the timesteps' (the r = t mask's
    uniforms and the pair's normals), the video and the audio noise's."""
    rng = model.apply(params, method=lambda m: m.make_rng("noise"),
                      rngs={"noise": key})
    r_cfg, r_ts, r_zv, r_za = jax.random.split(rng, 4)
    r_eq, r_pair = jax.random.split(r_ts)
    x, audio = batch[:2]
    b, n = x.shape[:2]
    has = jax_handle_cfg(r_cfg, jnp.ones((b,), bool), MFT["cfg_prob"])
    return dict(
        has_controls=t(has), r_ts=r_ts,
        u=t(jax.random.uniform(r_eq, (b, n))),
        pair=t(jax.random.normal(r_pair, (b, n, 2))),
        z_video=t(jax.random.normal(r_zv, x.shape, jnp.float32)),
        z_audio=t(jax.random.normal(r_za, audio.shape, jnp.float32)))


def test_sample_timesteps_on_jax_draws():
    batch = _data()
    model, params = jax_core(JaxGameMFTAudio, jax_config(**MFT), *batch,
                             rngs=MODEL_RNGS)
    draws = _jax_draws(model, params, batch, jax.random.key(2))
    jts, jrs = model.apply(params, draws["r_ts"], 2, 4,
                           method=model.sample_timesteps)
    port = carried(GameMFTAudio, port_config(**MFT), params)
    ts, rs = port.sample_timesteps(2, 4, u=draws["u"], pair=draws["pair"])
    np.testing.assert_allclose(ts.numpy(), np.asarray(jts), atol=1e-6)
    np.testing.assert_allclose(rs.numpy(), np.asarray(jrs), atol=1e-6)
    assert (rs == ts).any() and (rs < ts).any()
    # the law of tests/test_meanflow.py on the port's own generator draws
    ts, rs = port.sample_timesteps(512, 16, torch.Generator().manual_seed(3))
    assert (rs <= ts + 1e-6).all() and ((ts > 0) & (ts < 1)).all()
    assert 0.2 < (rs == ts).float().mean().item() < 0.45


@pytest.mark.parametrize("remat", ["off", "group"])
def test_loss_and_gradients_match_jax(remat):
    """Loss, its two parts and every parameter's gradient, on the JAX
    model's draws; under group remat the port's DiT runs the jvp's blocks
    without checkpointing (JAX's nn.remat composes with jax.jvp)."""
    over = {} if remat == "off" else dict(gradient_checkpointing=True,
                                          remat_granularity="group")
    batch = _data()
    model, params = jax_core(JaxGameMFTAudio, jax_config(**dict(MFT, **over)),
                             *batch, rngs=MODEL_RNGS)
    key = jax.random.key(3)     # one row dropped, one on the CFG tangent
    draws = _jax_draws(model, params, batch, key)
    jin = [jnp.asarray(a) for a in batch]

    def loss_fn(p):
        loss, lv, la = model.apply({"params": p}, *jin, rngs={"noise": key})
        return loss, (lv, la)

    (jl, (jlv, jla)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params["params"])

    port = carried(GameMFTAudio, port_config(**dict(MFT, **over)), params)
    ts, rs = port.sample_timesteps(2, 4, u=draws["u"], pair=draws["pair"])
    in_window = ((ts >= 0.3) & (ts <= 0.8)).float().mean(1) >= 0.25
    assert draws["has_controls"].tolist() == [False, True]
    assert in_window[1]
    loss, lv, la = port(*(t(a) for a in batch),
                        has_controls=draws["has_controls"], ts=ts, rs=rs,
                        z_video=draws["z_video"], z_audio=draws["z_audio"])
    for got, want in ((loss, jl), (lv, jlv), (la, jla)):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    loss.backward()
    want = params_from_jax(numpy_params({"params": jgrads}), MFT["n_heads"])
    got = {n: p.grad for n, p in port.named_parameters()}
    assert set(got) == set(want) and any("r_embed" in n for n in got)
    for name, g in got.items():
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)


def test_interval_embedding_changes_the_core_output():
    """u(x, r, t) depends on the interval (r_embed), and the port's core
    equals the JAX core on carried weights at r = 0 and r = t / 2."""
    x, audio, mouse, btn = _data()
    tt = np.full((2, 4), 0.8, np.float32)
    jcore, params = jax_core(JaxGameMFTAudioCore, jax_config(**MFT), x,
                             audio, tt, mouse, btn)
    core = carried(GameMFTAudioCore, port_config(**MFT), params)
    outs = []
    for r in (np.zeros_like(tt), tt * 0.5):
        (jv, ja), _ = jax_apply(jcore, params, x, audio, tt, mouse, btn,
                                r=r)
        with torch.no_grad():
            pv, pa = core(*(t(a) for a in (x, audio, tt, mouse, btn)),
                          r=t(r))
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=1e-5)
        np.testing.assert_allclose(pa.numpy(), np.asarray(ja), atol=1e-5)
        outs.append(pv)
    assert (outs[0] - outs[1]).abs().max().item() > 1e-6


def test_jvp_tangent_matches_a_central_difference():
    """The port's jvp of the core along (dx, dr = 0, dt = 1) against a
    central difference in float64 (Richardson-extrapolated, h = 1e-3).
    The core keeps its norms, RoPE, logits and the sin / cos of 1000 t of
    its timestep embeddings in float32, as the JAX package does, and u
    turns quickly with t; so the difference carries ~1e-4 of float32
    rounding over h and the check holds to atol 2e-3 of a tangent of
    magnitude ~1."""
    core = GameMFTAudioCore(port_config(**MFT), dtype=torch.float64,
                            device="cpu").double()
    rs = np.random.RandomState(5)
    x, audio, mouse, btn = (t(a).double() for a in _data())
    ts = torch.from_numpy(rs.uniform(0.3, 0.9, (2, 4)))
    r = ts * 0.5
    dx = torch.from_numpy(rs.randn(*x.shape))
    da = torch.from_numpy(rs.randn(*audio.shape))

    def f(zv, za, tt):
        with torch.no_grad():
            return core(zv, za, tt, mouse, btn, r=r)

    _, tangent = torch.func.jvp(
        lambda zv, za, rr, tt: core(zv, za, tt, mouse, btn, r=rr),
        (x, audio, r, ts), (dx, da, torch.zeros_like(r), torch.ones_like(ts)))

    def quotient(h):
        plus = f(x + h * dx, audio + h * da, ts + h)
        minus = f(x - h * dx, audio - h * da, ts - h)
        return [(p - m) / (2 * h) for p, m in zip(plus, minus)]

    h = 1e-3
    for got, d1, d2 in zip(tangent, quotient(h), quotient(h / 2)):
        assert got.abs().max().item() > 0.1
        torch.testing.assert_close(got, (4 * d2 - d1) / 3, rtol=0,
                                   atol=2e-3)


def test_params_from_jax_carries_the_meanflow_tree():
    batch = _data()
    _, params = jax_core(JaxGameMFTAudio, jax_config(**MFT), *batch,
                         rngs=MODEL_RNGS)
    sd = params_from_jax(numpy_params(params), MFT["n_heads"])
    assert {k for k in sd if k.startswith("core.r_embed.")} == {
        k for k in GameMFTAudio(port_config(**MFT), device="cpu")
        .state_dict() if k.startswith("core.r_embed.")}
    # strict: every key of the tree and the module
    carried(GameMFTAudio, port_config(**MFT), params)
    assert get_model_cls("game_mft_audio") is GameMFTAudio
    assert get_core_cls("game_mft_audio") is GameMFTAudioCore


def test_av_trainer_takes_meanflow_steps(tmp_path):
    """The ``av`` trainer trains ``game_mft_audio`` unchanged: 2 steps on
    the CPU, finite losses, the parameters moved."""
    raw = {"model": dict(MFT, gradient_checkpointing=True,
                         remat_granularity="group"),
           "train": dict(trainer_id="av", data_id="synthetic_av",
                         data_kwargs=dict(window_length=4, channels=4,
                                          audio_channels=4, sample_size=2,
                                          n_buttons=3),
                         target_batch_size=2, batch_size=2, opt="AdamW",
                         opt_kwargs=dict(lr=1e-3), vae_scale=0.87,
                         save_interval=1000, log_interval=1,
                         checkpoint_dir=str(tmp_path / "ckpt")),
           "wandb": {"run_name": "port_mft"}}
    trainer = get_trainer_cls("av")(Config.from_dict(raw), device="cpu")
    logged = []
    trainer.logger.log = lambda log, step: logged.append(dict(log))
    before = {n: p.detach().clone() for n, p in
              trainer.init_state().model.named_parameters()}
    state = trainer.train(max_steps=2)
    assert type(state.model) is GameMFTAudio and state.step == 2
    assert len(logged) == 2
    for log in logged:
        for key in ("diffusion_loss", "video_loss", "audio_loss"):
            assert np.isfinite(log[key]), key
    moved = [n for n, p in state.model.named_parameters()
             if not torch.equal(p, before[n])]
    assert len(moved) == len(before)


def test_jvp_through_k1_is_refused_in_both_packages():
    """At L >= 1024 on the card both packages reach their frame-mask
    kernel, which has a custom backward and no forward-mode rule: JAX's
    jvp refuses splash's custom_vjp, and the port's kernel launch refuses
    a torch.func transform (the check runs before any device work, so it
    shows here). Neither package gets a rule the reference lacks."""
    from owl_audio_exps_tpu.ops.splash import \
        splash_attention as jax_splash
    from owl_audio_exps_tpu_torch.ops import splash
    rs = np.random.RandomState(0)
    q, k, v = (rs.randn(1, 1, 256, 64).astype(np.float32) for _ in range(3))
    with pytest.raises(TypeError, match="custom_vjp"):
        jax.jvp(lambda a: jax_splash(a, jnp.asarray(k), jnp.asarray(v), 4,
                                     None, True, interpret=True),
                (jnp.asarray(q),), (jnp.ones_like(q),))
    with pytest.raises(RuntimeError, match="torch.func transform"):
        torch.func.jvp(lambda a: splash.frame_attention_cuda(
            a, t(k), t(v), 4, None, True), (t(q),), (torch.ones(1, 1, 256,
                                                                 64),))
