"""The port's dual-stream MMDiT (nn/mmattn.py) and the paths it takes in
the AV model, its training wrapper, the MeanFlow core, the samplers, the
serve pipeline and the trainer, against the JAX package on the CPU at
tests/test_mmdit.py's sizes (2-3 layers, d 32, 2 heads, sample size 2,
tpf 5), in float32.

JAX params are carried across with ``params_from_jax`` (every key must
match, ``strict=True``); inputs are numpy from a seed; the noise is the
JAX code's own draw, handed to the port. The JAX package takes its dense
path on the CPU; the port runs its dense path and its kernel route
(``attn_impl: splash``: K1's plain version on CPU tensors), the same
function. Tolerances, stated per test: forwards 1e-4 relative of the
output's scale (atol 1e-4 on outputs of magnitude ~1); losses rtol 1e-5
and gradients atol 1e-5 / rtol 1e-3 (float32 reassociation); the golden
replay the JAX golden test's own (max relative 1e-3 a step, 2e-3 final).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_audio_exps_tpu.configs import Config as JaxConfig
from owl_audio_exps_tpu.configs import transformer_config as jax_config
from owl_audio_exps_tpu.data.synthetic import get_loader as jax_loader
from owl_audio_exps_tpu.models.gamemft_audio import \
    GameMFTAudioCore as JaxMFTCore
from owl_audio_exps_tpu.models.gamerft_audio import \
    GameRFTAudio as JaxGameRFTAudio
from owl_audio_exps_tpu.models.gamerft_audio import \
    GameRFTAudioCore as JaxAVCore
from owl_audio_exps_tpu.nn.kv_cache import KVCache as JaxKVCache
from owl_audio_exps_tpu.sampling.av_caching import \
    AVCachingSamplerV2 as JaxAVCachingSamplerV2
from owl_audio_exps_tpu.sampling import get_sampler_cls as jax_sampler_cls
from owl_audio_exps_tpu.sampling import schedulers as jsched
from owl_audio_exps_tpu.trainers import get_trainer_cls as jax_trainer_cls
from owl_audio_exps_tpu.trainers.rft_trainer import _stack_accum
from owl_audio_exps_tpu.utils.telemetry import watch_metrics as jax_watch
from owl_audio_exps_tpu.utils.torch_import import export_torch_state_dict
from owl_audio_exps_tpu_torch.configs import Config
from owl_audio_exps_tpu_torch.models.gamemft_audio import GameMFTAudioCore
from owl_audio_exps_tpu_torch.models.gamerft_audio import (GameRFTAudio,
                                                           GameRFTAudioCore)
from owl_audio_exps_tpu_torch.nn.attn import attention_forwards_per_step
from owl_audio_exps_tpu_torch.nn.kv_cache import KVCache
from owl_audio_exps_tpu_torch.nn.mmattn import MMDiT
from owl_audio_exps_tpu_torch.ops import splash
from owl_audio_exps_tpu_torch.sampling import get_sampler_cls
from owl_audio_exps_tpu_torch.sampling.av_caching import AVCachingSamplerV2
from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
from owl_audio_exps_tpu_torch.utils.checkpoints import load_torch_file
from owl_audio_exps_tpu_torch.utils.telemetry import watch_metrics
from owl_audio_exps_tpu_torch.utils.weights import params_from_jax

from torch_port_util import (MODEL_RNGS, TINY_AV, assert_same_state, av_cores,
                             av_inputs, carried, jax_apply, jax_core,
                             numpy_params, t)

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "goldens")
MM = dict(TINY_AV, backbone="mmdit", n_buttons=3, cfg_prob=0.1,
          causal=True)


def _cfgs(**over):
    kw = dict(MM, **over)
    return jax_config(**kw), Config.from_dict({"model": kw}).model


def _close(got, want, what=""):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               atol=1e-4 * scale, rtol=0, err_msg=what)


# ---------------------------------------------------------------- forward

@pytest.mark.parametrize("attn_impl", ["auto", "splash"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_mmdit_core_matches_jax(causal, attn_impl):
    """The MMDiT core on the dense route and on K1's route (its plain
    version on the CPU, no launch) against the JAX core: atol 1e-4."""
    jcfg, pcfg = _cfgs(causal=causal)
    pcfg.attn_impl = attn_impl
    inputs = av_inputs(np.random.RandomState(0), 2, 4, jcfg)
    has = np.array([True, False])
    jcore, params = jax_core(JaxAVCore, jcfg, *inputs)
    (vj, aj), _ = jax_apply(jcore, params, *inputs, has_controls=has)
    port = carried(GameRFTAudioCore, pcfg, params)
    assert isinstance(port.transformer, MMDiT)
    calls = []
    orig = splash.splash_attention
    splash.splash_attention = lambda *a, **kw: (calls.append(a[3]),
                                                orig(*a, **kw))[1]
    try:
        before = splash.launches
        with torch.no_grad():
            vp, ap = port(*(t(a) for a in inputs), has_controls=t(has))
        assert splash.launches == before
    finally:
        splash.splash_attention = orig
    # the kernel route: every layer (window 2 frames x 5 tokens does not
    # make a band over 20 tokens at tpf 5 and 2 frames of window) on K1
    assert len(calls) == (pcfg.n_layers if attn_impl == "splash" else 0)
    _close(vp, vj, "video")
    _close(ap, aj, "audio")


def test_mmdit_params_from_jax_round_trips():
    """params_from_jax covers every key of the port's MMDiT core and its
    training wrapper, with the reference's names (qkv_projs.i,
    out_projs.i, mlps.i, cond_proj.1), and equals the JAX package's own
    export to the torch reference layout."""
    jcfg, pcfg = _cfgs()
    inputs = av_inputs(np.random.RandomState(1), 1, 2, jcfg)
    _, params = jax_core(JaxAVCore, jcfg, *inputs)
    sd = params_from_jax(numpy_params(params), jcfg.n_heads)
    port = GameRFTAudioCore(pcfg, dtype=torch.float32, device="cpu")
    assert set(sd) == set(port.state_dict())
    for name in ("transformer.blocks.0.attn.qkv_projs.1.weight",
                 "transformer.blocks.1.attn.out_projs.0.bias",
                 "transformer.blocks.0.mlps.1.fc2.weight",
                 "transformer.cond_proj.1.weight"):
        assert name in sd
    ref = export_torch_state_dict(numpy_params(params["params"]),
                                  jcfg.n_heads)
    assert set(ref) == set(sd)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v),
                                      err_msg=k)
    wrapper = GameRFTAudio(pcfg, dtype=torch.float32, device="cpu")
    wsd = params_from_jax(numpy_params({"params": {"core": params[
        "params"]}}), jcfg.n_heads)
    assert set(wsd) == set(wrapper.state_dict())


# ------------------------------------------------------------------ cache

@pytest.mark.parametrize("decoding", [False, True])
def test_mmdit_kv_cache_matches_jax_and_the_uncached_forward(decoding):
    """tests/test_mmdit.py::test_mmdit_kv_cache_equivalence on the port:
    the context written into the ring, then the last frame against it
    equals the uncached forward's last frame (atol 2e-4, the JAX test's);
    the cached velocities and the ring state equal the JAX package's
    (atol 1e-4; counters exact)."""
    jcfg, pcfg = _cfgs()
    inputs = av_inputs(np.random.RandomState(2), 1, 6, jcfg)
    n = 6
    jcore, params = jax_core(JaxAVCore, jcfg, *inputs)
    port = carried(GameRFTAudioCore, pcfg, params)
    args = [t(a) for a in inputs]
    with torch.no_grad():
        fv, fa = port(*args)
    jc = JaxKVCache.from_config(jcfg, 1, dtype=jnp.float32)
    _, jc = jax_apply(jcore, params, *(a[:, :n - 1] for a in inputs),
                      kv_cache=jc, write=True)
    (jv, ja), _ = jax_apply(jcore, params, *(a[:, n - 1:] for a in inputs),
                            kv_cache=jc, decoding=decoding)
    pc = KVCache.from_config(pcfg, 1, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        port(*(a[:, :n - 1] for a in args), kv_cache=pc, write=True)
        assert_same_state(jc, pc, atol=1e-4)
        assert int(pc.length) == (n - 1) * pcfg.tokens_per_frame
        lv, la = port(*(a[:, n - 1:] for a in args), kv_cache=pc,
                      decoding=decoding)
    torch.testing.assert_close(lv[:, 0], fv[:, -1], atol=2e-4, rtol=0)
    torch.testing.assert_close(la[:, 0], fa[:, -1], atol=2e-4, rtol=0)
    _close(lv, jv, "video")
    _close(la, ja, "audio")


def test_mmdit_fused_write_commits_every_frame_as_in_jax():
    """The JAX MMDiT takes no write_len: a 2-frame write-forward with
    write_len=1 (the samplers' fused write) commits both frames, and the
    port keeps it: ring state and velocities against the JAX package
    (atol 1e-4, counters exact); the DiT commits one."""
    for backbone, committed in (("mmdit", 2), ("dit", 1)):
        jcfg, pcfg = _cfgs(backbone=backbone)
        inputs = av_inputs(np.random.RandomState(3), 1, 5, jcfg)
        jcore, params = jax_core(JaxAVCore, jcfg, *inputs)
        port = carried(GameRFTAudioCore, pcfg, params)
        jc = JaxKVCache.from_config(jcfg, 1, dtype=jnp.float32)
        pc = KVCache.from_config(pcfg, 1, dtype=torch.float32, device="cpu")
        head = [a[:, :3] for a in inputs]
        two = [a[:, 3:5] for a in inputs]
        _, jc = jax_apply(jcore, params, *head, kv_cache=jc, write=True)
        (jv, ja), jc = jax_apply(jcore, params, *two, kv_cache=jc,
                                 write=True, write_len=1)
        with torch.no_grad():
            port(*(t(a) for a in head), kv_cache=pc, write=True)
            pv, pa = port(*(t(a) for a in two), kv_cache=pc, write=True,
                          write_len=1)
        assert int(pc.length) == (3 + committed) * pcfg.tokens_per_frame
        assert_same_state(jc, pc, atol=1e-4)
        _close(pv, jv, f"{backbone} video")
        _close(pa, ja, f"{backbone} audio")


# ---------------------------------------------------------------- wrapper

@pytest.mark.parametrize("cfg_prob", [None, 0.5])
def test_mmdit_return_dict_loss_and_gradients_match_jax(cfg_prob):
    """GameRFTAudio(return_dict=True, cfg_prob=) on the JAX model's draws:
    every entry of the dict (rtol 1e-5, atol 1e-5), the loss (rtol 1e-5)
    and every gradient (atol 1e-5, rtol 1e-3), through K1's route."""
    jcfg, pcfg = _cfgs(cfg_prob=0.25)
    pcfg.attn_impl = "splash"
    rs = np.random.RandomState(4)
    x, a, _, m, b = av_inputs(rs, 4, 4, jcfg)
    batch = [jnp.asarray(v) for v in (x, a, m, b)]
    model, params = jax_core(JaxGameRFTAudio, jcfg, *batch,
                             rngs=MODEL_RNGS)

    def loss_and_draw(p):
        out = model.apply(p, *batch, return_dict=True, cfg_prob=cfg_prob,
                          rngs={"noise": jax.random.key(5)})
        return out["diffusion_loss"], out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss_and_draw, has_aux=True))(params)
    port = carried(GameRFTAudio, pcfg, params)
    got = port(*(t(v) for v in (x, a, m, b)), ts=t(out["ts"]),
               z_video=t(out["z_video"]), z_audio=t(out["z_audio"]),
               has_controls=t(out["cfg_mask"]), return_dict=True,
               cfg_prob=cfg_prob)
    assert set(got) == set(out)
    got["diffusion_loss"].backward()
    for key, value in out.items():
        np.testing.assert_allclose(got[key].detach().float().numpy(),
                                   np.asarray(value, np.float32), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    want = params_from_jax(numpy_params(grads), jcfg.n_heads)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=1e-3, err_msg=name)


def test_mmdit_remat_changes_neither_loss_nor_gradients():
    """Block remat (every block checkpointed, remat_granularity ignored as
    the JAX MMDiT ignores it) against the plain step: loss rel 1e-6,
    gradients atol 1e-6; 2 attention forwards a layer."""
    _, pcfg = _cfgs(n_layers=3)
    _, rcfg = _cfgs(n_layers=3, gradient_checkpointing=True,
                    remat_granularity="group")
    for c in (pcfg, rcfg):
        c.attn_impl = "splash"
    assert attention_forwards_per_step(rcfg) == [2, 2, 2]
    rs = np.random.RandomState(5)
    x, a, _, m, b = (t(v) for v in av_inputs(rs, 2, 4, pcfg))
    out = []
    for c in (pcfg, rcfg):
        model = GameRFTAudio(c, dtype=torch.float32, device="cpu", seed=0)
        calls = []
        orig = splash.splash_attention
        splash.splash_attention = lambda *q, **kw: (calls.append(1),
                                                    orig(*q, **kw))[1]
        try:
            loss, _, _ = model(x, a, m, b,
                               generator=torch.Generator().manual_seed(2))
            loss.backward()
        finally:
            splash.splash_attention = orig
        out.append((loss.item(), len(calls), {n: p.grad for n, p in
                                              model.named_parameters()}))
    (l0, n0, g0), (l1, n1, g1) = out
    assert l1 == pytest.approx(l0, rel=1e-6, abs=0)
    assert (n0, n1) == (3, 6)
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("backbone", ["mmdit", "uvit"])
def test_meanflow_core_backbones_match_jax(backbone):
    """GameMFTAudioCore with the MMDiT and the UViT against the JAX core:
    atol 1e-4."""
    over = dict(backbone=backbone, model_id="game_mft_audio")
    if backbone == "uvit":
        over["n_layers"] = 3
    jcfg, pcfg = _cfgs(**over)
    x, a, ts, m, b = av_inputs(np.random.RandomState(6), 2, 4, jcfg)
    r = ts * 0.5
    core, params = jax_core(JaxMFTCore, jcfg, x, a, ts, m, b)
    (vj, aj), _ = jax_apply(core, params, x, a, ts, m, b, r=r)
    port = carried(GameMFTAudioCore, pcfg, params)
    with torch.no_grad():
        vp, ap = port(*(t(v) for v in (x, a, ts, m, b)), r=t(r))
    _close(vp, vj, "video")
    _close(ap, aj, "audio")


# ---------------------------------------------------------------- goldens

@pytest.mark.parametrize("name,over", [
    ("reference_av_mmdit", {"backbone": "mmdit"}),
    ("reference_av_uvit", {"backbone": "uvit", "n_layers": 3})])
def test_reference_golden_replays_through_the_port(name, over):
    """tests/test_reference_golden.py::test_golden_trajectory_parity on the
    port: the reference's state_dict loaded directly (load_torch_file of
    the golden, strict), its Euler trajectory replayed; each step's
    velocities within max relative 1e-3 of the golden, the final latents
    2e-3 (the JAX test's tolerances)."""
    path = os.path.join(GOLDENS, name + ".npz")
    g = np.load(path)
    kw = dict(model_id="game_rft_audio", n_layers=2, n_heads=2, d_model=32,
              channels=4, sample_size=2, tokens_per_frame=5, n_frames=8,
              n_buttons=3, causal=True, uncond=False, cfg_prob=0.0,
              backbone="dit", has_audio=True, rope_impl="ortho",
              local_window=2, global_window=None, audio_channels=6)
    kw.update(over)
    pcfg = Config.from_dict({"model": kw}).model
    core = GameRFTAudioCore(pcfg, dtype=torch.float32, device="cpu",
                            seed=None)
    core.load_state_dict(load_torch_file(path), strict=True)
    mouse, btn = t(g["mouse"]), t(g["btn"])
    cur_v, cur_a = t(g["x"]), t(g["audio"])
    b, n = cur_v.shape[:2]
    tt = torch.ones(b, n)
    dt = np.asarray(g["dt"], np.float32)

    def rel(mine, ref):
        scale = max(1e-3, float(np.abs(ref).max()))
        return float(np.abs(mine.numpy() - ref).max()) / scale

    with torch.no_grad():
        for i in range(len(dt)):
            pv, pa = core(cur_v, cur_a, tt, mouse, btn)
            assert rel(pv, g[f"v_video_{i}"]) < 1e-3, f"step {i} video"
            assert rel(pa, g[f"v_audio_{i}"]) < 1e-3, f"step {i} audio"
            cur_v = cur_v - float(dt[i]) * pv
            cur_a = cur_a - float(dt[i]) * pa
            tt = tt - float(dt[i])
    assert rel(cur_v, g["final_video"]) < 2e-3
    assert rel(cur_a, g["final_audio"]) < 2e-3


# --------------------------------------------------------------- samplers

def test_causal_window_sampler_over_the_mmdit_matches_jax():
    """mmdit_v1's eval sampler (av_causal): _denoise_frame over the MMDiT
    core on the same window against the JAX sampler's, atol 1e-4 (its
    rings are the MMDiT's cached forwards: step 0 writes the window, then
    the denoising frame is dropped)."""
    jcfg, pcfg, jcore, params, port = av_cores(backbone="mmdit")
    W = 4
    x, a, _, m, b = av_inputs(np.random.RandomState(7), 2, W, pcfg)
    wt = np.full((2, W), 0.2, np.float32)
    wt[:, -1] = 1.0
    dt = jsched.resolve_schedule(3, None)
    kw = dict(n_steps=3, cfg_scale=1.3, window_length=W, num_frames=1)
    arrays = (x, a, wt, m, b)
    ref_x, ref_a = jax.jit(
        lambda p, *arr: jax_sampler_cls("av_causal")(**kw)._denoise_frame(
            jcore, p, *arr, dt, jax.random.key(1)))(
        params, *(jnp.asarray(v) for v in arrays))
    got_x, got_a = get_sampler_cls("av_causal")(**kw)._denoise_frame(
        port, *(t(v) for v in arrays), dt)
    _close(got_x, ref_x, "video")
    _close(got_a, ref_a, "audio")


@pytest.mark.parametrize("case", ["steady_1", "plain_1", "steady_2"])
def test_av_serve_over_the_mmdit_matches_jax(case):
    """AVCachedStreamingPipeline over the MMDiT core against the JAX
    pipeline on its own draws (tests/test_torch_port_cached_serve.py's
    harness and tolerances): with the fused write the JAX MMDiT commits
    both frames of each steady tick's forward, and so does the port, ring
    for ring."""
    from test_torch_port_cached_serve import _run
    pp, _ = _run("av", case, backbone="mmdit")
    assert isinstance(pp.core.transformer, MMDiT)


def test_av_caching_sampler_refuses_an_av_core_in_both_packages():
    """mmdit_v2's eval sampler, av_caching, samples video cores: on the
    MMDiT (any AV) core the JAX sampler fails, and the port's raises
    TypeError (train.py cuts it from the av trainer's eval)."""
    jcfg, pcfg, jcore, params, port = av_cores(backbone="mmdit")
    x, a, _, m, b = av_inputs(np.random.RandomState(8), 1, 3, pcfg)
    mouse = np.concatenate([m, m], axis=1)
    btn = np.concatenate([b, b], axis=1)
    with pytest.raises(Exception):
        JaxAVCachingSamplerV2(n_steps=2, cfg_scale=1.0, num_frames=3)(
            jcore, params, jnp.asarray(x), jnp.asarray(mouse),
            jnp.asarray(btn), jax.random.key(0))
    with pytest.raises(TypeError, match="video core"):
        AVCachingSamplerV2(n_steps=2, cfg_scale=1.0, num_frames=3)(
            port, t(x), t(mouse), t(btn))


# ---------------------------------------------------------------- trainer

def _mmdit_v2_dict(tmp_path, watch):
    """A tiny configs/mmdit_v2.yml: Muon with its adamw_keys, a causal
    MMDiT with a finite global window."""
    return {
        "model": dict(MM, global_window=4, n_frames=8),
        "train": dict(
            trainer_id="av", data_id="synthetic_av",
            data_kwargs=dict(window_length=8, channels=4, audio_channels=4,
                             sample_size=2, n_buttons=3),
            target_batch_size=2, batch_size=2, opt="Muon",
            opt_kwargs=dict(lr=1e-3, momentum=0.95, adamw_lr=1e-4,
                            adamw_wd=1e-4, adamw_eps=1e-15,
                            adamw_betas=[0.9, 0.95],
                            adamw_keys=["core.proj_in",
                                        "core.proj_out.proj"]),
            vae_scale=0.63, audio_vae_scale=0.0357, save_interval=1000,
            log_interval=1, watch=watch, watch_bins=16,
            checkpoint_dir=str(tmp_path / "ckpt")),
        "wandb": {"run_name": "port_mmdit_v2"}}


def test_mmdit_v2_trainer_step_matches_jax(tmp_path):
    """One AVRFTTrainer step on a tiny mmdit_v2 (Muon, adamw_keys
    core.proj_in and core.proj_out.proj, every non-2-D leaf on AdamW)
    against the JAX trainer's jitted step on the same synthetic batch and
    the JAX step's noise: the Muon/AdamW labels leaf for leaf; the loss
    and metrics rtol 1e-5; the watch norms rtol 1e-4; the gradients the
    optimizer receives atol 1e-5 / rtol 1e-3; AdamW leaves atol 1e-6;
    Muon leaves' updates in the same direction (cosine > 0.8; the Muon
    arithmetic is held on full-rank gradients by
    tests/test_torch_port_train.py::test_muon_adamw_step_matches_jax)."""
    raw = _mmdit_v2_dict(tmp_path, "norms")
    jtr = jax_trainer_cls("av")(JaxConfig.from_dict(raw))
    jtr.model = JaxGameRFTAudio(jtr.model_cfg, dtype=jnp.float32)
    state = jtr.init_state()
    params0 = numpy_params(state.params)
    kw = raw["train"]["data_kwargs"]
    batch = next(iter(jax_loader("synthetic_av", 2, **kw)))
    rng = jax.random.key(11)
    step = jtr.make_train_step(jtr._wrapped_loss, 1,
                               clip_norm=jtr.grad_clip_norm())
    new_state, metrics_j = step(state, _stack_accum([batch]), rng)
    vid = (jnp.asarray(batch[0]) / 0.63).astype(jnp.bfloat16)
    audio = (jnp.asarray(batch[1]) / 0.0357).astype(jnp.bfloat16)
    out = jax_apply(jtr.model, {"params": params0}, vid, audio,
                    batch[2], batch[3], return_dict=True,
                    rngs={"noise": jax.random.split(rng, 1)[0]})

    ptr = get_trainer_cls("av")(Config.from_dict(raw), device="cpu")
    model = carried(GameRFTAudio, ptr.model_cfg, {"params": params0})
    pstate = ptr.make_state(model.train())
    labels = pstate.optimizer.labels
    assert {n for n, lab in labels.items() if lab == "adamw"} == {
        n for n, p in model.named_parameters()
        if p.ndim < 2 or n.startswith(("core.proj_in.",
                                       "core.proj_out.proj."))}
    draws = dict(ts=t(out["ts"]), z_video=t(out["z_video"]),
                 z_audio=t(out["z_audio"]), has_controls=t(out["cfg_mask"]))
    forward = model.forward
    model.forward = lambda vid, audio, mouse, btn, has_controls=None, \
        generator=None: forward(vid, audio, mouse, btn, **draws)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    seen = {}
    opt_step = pstate.optimizer.step

    def step_with_grads():
        seen.update({n: p.grad.clone() for n, p in model.named_parameters()})
        opt_step()

    pstate.optimizer.step = step_with_grads
    metrics_p = ptr.train_step(pstate, [ptr.to_device(batch)],
                               torch.Generator(),
                               clip_norm=ptr.grad_clip_norm())
    assert set(metrics_p) == set(metrics_j)
    assert any(k.startswith("watch/grad_norm/core/") for k in metrics_p)
    for key, value in metrics_j.items():
        np.testing.assert_allclose(
            float(metrics_p[key]), float(value), err_msg=key,
            rtol=1e-4 if key.startswith(("watch", "param_norm")) else 1e-5)
    grads_j = jax.jit(jax.grad(lambda p: jtr.model.apply(
        {"params": p}, vid, audio, jnp.asarray(batch[2]),
        jnp.asarray(batch[3]), return_dict=True,
        rngs={"noise": jax.random.split(rng, 1)[0]})["diffusion_loss"]))(
        params0)
    gwant = params_from_jax(numpy_params(grads_j), jtr.model_cfg.n_heads)
    for name, g in seen.items():
        np.testing.assert_allclose(g.numpy(), gwant[name].numpy(),
                                   atol=1e-5, rtol=1e-3, err_msg=name)
    want = params_from_jax(numpy_params(new_state.params),
                           jtr.model_cfg.n_heads)
    for name, p in pstate.model.named_parameters():
        if labels[name] == "adamw":
            np.testing.assert_allclose(p.detach().numpy(),
                                       want[name].numpy(), atol=1e-6,
                                       rtol=1e-5, err_msg=name)
        else:
            # 5 bf16 NS5 iterations of the same gradient in either
            # framework: on these low-rank gradients they lie up to 57%
            # apart in Frobenius norm (each up to 17% from float64 NS5
            # even on an orthogonal matrix), so the directions are held
            d_port = (p.detach() - before[name]).numpy().ravel()
            d_jax = (want[name] - before[name]).numpy().ravel()
            cos = d_port @ d_jax / np.linalg.norm(d_port) / \
                np.linalg.norm(d_jax)
            assert cos > 0.8, (name, cos)


@pytest.mark.parametrize("bins", [16, 64])
def test_watch_matches_jax_watch_metrics(bins):
    """utils/telemetry.py against the JAX package's watch_metrics on the
    same parameter and gradient trees (an MMDiT GameRFTAudio's, the
    gradients seeded numpy): the per-module norms rtol 1e-6, the
    histograms' counts exact, lo and hi exact."""
    jcfg, pcfg = _cfgs()
    x, a, _, m, b = av_inputs(np.random.RandomState(9), 1, 2, jcfg)
    _, params = jax_core(JaxGameRFTAudio, jcfg, x, a, m, b,
                         rngs=MODEL_RNGS)
    rs = np.random.RandomState(10)
    grads = jax.tree.map(
        lambda p: jnp.asarray(rs.randn(*p.shape).astype(np.float32)),
        params)
    want = jax_watch(params["params"], grads["params"], "full", bins=bins)
    port = carried(GameRFTAudio, pcfg, params)
    g = params_from_jax(numpy_params(grads), jcfg.n_heads)
    for name, p in port.named_parameters():
        p.grad = g[name]
    got = watch_metrics(port.named_parameters(), "full", bins=bins)
    assert set(got) == set(want)
    for key, value in want.items():
        if key.startswith("watch_hist/"):
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(value), err_msg=key)
        else:
            np.testing.assert_allclose(float(got[key]), float(value),
                                       rtol=1e-6, err_msg=key)
    norms = watch_metrics(port.named_parameters(), "norms")
    assert set(norms) == {k for k in want if k.startswith("watch/")}


def test_mmdit_v2_cuts_and_the_cli_on_the_cpu(tmp_path, capsys):
    """train.py's port cuts of the two MMDiT configs (mmdit_v1's S3 loader
    -> synthetic_av, printed; mmdit_v2's cod kept where its table exists,
    its av_caching eval dropped, printed), and the CLI running a tiny
    mmdit trainer with watch full on the CPU."""
    import yaml
    from owl_audio_exps_tpu_torch.train import main, port_cuts
    repo = os.path.dirname(GOLDENS.rsplit(os.sep, 1)[0])
    v1 = Config.from_yaml(os.path.join(repo, "configs", "mmdit_v1.yml"))
    lines = port_cuts(v1, 1)
    assert v1.train.data_id == "synthetic_av"
    assert any("cod_s3_audio" in ln and "boto3" in ln for ln in lines)
    v2 = Config.from_yaml(os.path.join(repo, "configs", "mmdit_v2.yml"))
    table = tmp_path / "table"
    table.mkdir()
    v2.train.data_kwargs.dataset_path = str(table)
    lines = port_cuts(v2, 1)
    assert v2.train.data_id == "cod"
    assert v2.train.sampler_id is None
    assert any("av_caching" in ln and "JAX package" in ln for ln in lines)

    raw = _mmdit_v2_dict(tmp_path, "full")
    raw["train"]["opt"], raw["train"]["opt_kwargs"] = "AdamW", {"lr": 1e-4}
    path = tmp_path / "mmdit.yml"
    path.write_text(yaml.safe_dump(raw))
    main(["--config_path", str(path), "--max_steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[step 2]" in out and "watch/grad_norm/core/transformer" in out


def test_mmdit_v2_batch_columns_fail_in_both_packages(tmp_path):
    """configs/mmdit_v2.yml's cod batch_columns [video, mouse, buttons,
    audio] reach the AV trainer, which reads [video, audio, mouse,
    buttons]: the mouse arrives as the audio stream and both packages'
    loss raises (chip_smoke.py phase 15 reorders the columns, printed);
    in the trainer's order both compute a finite loss."""
    from owl_audio_exps_tpu.data.cod_latent import get_loader as jax_cod
    from owl_audio_exps_tpu_torch.data.npy_table import NpyTable
    table = NpyTable(str(tmp_path / "tbl"), columns=[
        "video", "audio", "mouse", "buttons", "tarball", "pt_idx",
        "missing", "truncated", "seq_len"],
        array_columns=["video", "audio", "mouse", "buttons"])
    rs = np.random.RandomState(14)
    for i in range(2):
        table.append(video=rs.randn(8, 4, 2, 2).astype(np.float16),
                     audio=rs.randn(8, 4).astype(np.float32),
                     mouse=rs.randn(8, 2).astype(np.float32),
                     buttons=(rs.rand(8, 3) > 0.5).astype(np.float32),
                     tarball="t", pt_idx=i, missing=False, truncated=False,
                     seq_len=8)
    raw = _mmdit_v2_dict(tmp_path, None)
    jtr = jax_trainer_cls("av")(JaxConfig.from_dict(raw))
    jtr.model = JaxGameRFTAudio(jtr.model_cfg, dtype=jnp.float32)
    params = jtr.init_state().params
    ptr = get_trainer_cls("av")(Config.from_dict(raw), device="cpu")
    model = carried(GameRFTAudio, ptr.model_cfg, {"params": params})
    loss_fn = jax.jit(jtr.loss_fn)
    written = ["video", "mouse", "buttons", "audio"]
    for cols, fails in ((written, True),
                        (["video", "audio", "mouse", "buttons"], False)):
        batch = next(iter(jax_cod(1, str(tmp_path / "tbl"), 8, cols)))
        port_batch = ptr.to_device(batch)
        if fails:
            with pytest.raises(Exception):
                loss_fn(params, [jnp.asarray(a) for a in batch],
                        jax.random.key(0))
            with pytest.raises(RuntimeError):
                ptr.loss_fn(model, port_batch, torch.Generator())
            continue
        loss_j, out = loss_fn(params, [jnp.asarray(a) for a in batch],
                              jax.random.key(0))
        assert np.isfinite(float(loss_j))
        loss_p, _ = ptr.loss_fn(model, port_batch,
                                torch.Generator().manual_seed(0))
        assert torch.isfinite(loss_p)
