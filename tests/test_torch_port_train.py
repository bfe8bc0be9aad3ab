"""The port's training path (GameRFT, Muon/AdamW, synthetic data, remat,
RFTTrainer) against the JAX package, on the CPU at tiny width.

Weights are carried from the JAX package with ``params_from_jax`` (every
key must match, ``strict=True``); inputs and the noise draw are numpy or
the JAX model's own draw, handed to both. Tolerances are stated per test:
float32 forward and loss atol 1e-4 / rtol 1e-5, gradients atol 1e-5 /
rtol 1e-3 (float32 reassociation), AdamW steps 1e-6 (the same
arithmetic); NS5 and the Muon update run in bf16, whose roundings differ
between the two frameworks, and are held to 1e-1 relative Frobenius
distance of each other and 8e-2 of float64 NS5.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from owl_audio_exps_tpu.configs import transformer_config as jax_config
from owl_audio_exps_tpu.data.synthetic import get_loader as jax_loader
from owl_audio_exps_tpu.models.gamerft import GameRFT as JaxGameRFT
from owl_audio_exps_tpu.models.gamerft import GameRFTCore as JaxCore
from owl_audio_exps_tpu.models.gamerft import handle_cfg as jax_handle_cfg
from owl_audio_exps_tpu.muon import init_muon as jax_init_muon
from owl_audio_exps_tpu.muon import muon_adamw_labels as jax_labels
from owl_audio_exps_tpu.muon import \
    zeropower_via_newtonschulz5 as jax_ns5
from owl_audio_exps_tpu_torch import muon
from owl_audio_exps_tpu_torch.configs import Config
from owl_audio_exps_tpu_torch.configs import transformer_config as port_config
from owl_audio_exps_tpu_torch.data import get_loader
from owl_audio_exps_tpu_torch.models import get_core_cls, get_model_cls
from owl_audio_exps_tpu_torch.models.gamerft import (GameRFT, GameRFTCore,
                                                    handle_cfg)
from owl_audio_exps_tpu_torch.nn.attn import attention_forwards_per_step
from owl_audio_exps_tpu_torch.ops import band, splash
from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
from owl_audio_exps_tpu_torch.trainers.base import clip_grad_norm
from owl_audio_exps_tpu_torch.utils.weights import params_from_jax

from torch_port_util import (MODEL_RNGS, carried, jax_apply, jax_core,
                             numpy_params, t)

TINY_VIDEO = dict(
    model_id="game_rft", n_layers=2, n_heads=2, d_model=32, channels=4,
    sample_size=2, tokens_per_frame=4, n_frames=8, n_buttons=3, causal=True,
    uncond=False, rope_impl="motion", rope_ats_delta=2.0, local_window=2,
    global_window=None, cfg_prob=0.25)


def _configs(**kw):
    kw = dict(TINY_VIDEO, **kw)
    return jax_config(**kw), port_config(**kw)


def _video_inputs(rs, b, n, cfg):
    p = cfg.sample_size
    return (rs.randn(b, n, cfg.channels, p, p).astype(np.float32),
            rs.randn(b, n, 2).astype(np.float32),
            (rs.rand(b, n, cfg.n_buttons) > 0.5).astype(np.float32))


# ------------------------------------------------------------------ model

def test_core_forward_matches_jax():
    jcfg, pcfg = _configs()
    rs = np.random.RandomState(0)
    x, mouse, btn = _video_inputs(rs, 2, 4, jcfg)
    ts = rs.rand(2, 4).astype(np.float32)
    has = np.array([True, False])
    core, params = jax_core(JaxCore, jcfg, x, ts, mouse, btn)
    want, _ = jax_apply(core, params, x, ts, mouse, btn, has_controls=has)
    port = carried(GameRFTCore, pcfg, params)
    with torch.no_grad():
        got = port(*(t(a) for a in (x, ts, mouse, btn)),
                   has_controls=t(has))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_params_from_jax_covers_every_key_of_the_wrapper():
    jcfg, pcfg = _configs()
    inputs = _video_inputs(np.random.RandomState(1), 1, 2, jcfg)
    _, params = jax_core(JaxGameRFT, jcfg, *inputs, rngs=MODEL_RNGS)
    sd = params_from_jax(numpy_params(params), jcfg.n_heads)
    want = GameRFT(pcfg, dtype=torch.float32, device="cpu").state_dict()
    assert set(sd) == set(want) and all(k.startswith("core.") for k in sd)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(want[k].shape), k


def test_loss_and_gradients_match_jax():
    jcfg, pcfg = _configs()
    rs = np.random.RandomState(2)
    inputs = _video_inputs(rs, 4, 4, jcfg)
    model, params = jax_core(JaxGameRFT, jcfg, *inputs, rngs=MODEL_RNGS)
    jin = [jnp.asarray(a) for a in inputs]
    rngs = {"noise": jax.random.key(5)}

    def loss_and_draw(p):
        out = model.apply(p, *jin, return_dict=True, rngs=rngs)
        return out["diffusion_loss"], out

    (loss_j, draw), grads_j = jax.jit(jax.value_and_grad(
        loss_and_draw, has_aux=True))(params)
    assert not bool(np.all(np.asarray(draw["cfg_mask"])))  # cfg dropped

    port = carried(GameRFT, pcfg, params)
    loss_p = port(*(t(a) for a in inputs), ts=t(draw["ts"]),
                  z=t(draw["z_video"]), has_controls=t(draw["cfg_mask"]))
    loss_p.backward()
    np.testing.assert_allclose(loss_p.item(), float(loss_j), rtol=1e-5)
    want = params_from_jax(numpy_params(grads_j), jcfg.n_heads)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=1e-3, err_msg=name)


def test_handle_cfg_keeps_the_exact_uncond_fraction():
    rs = np.random.RandomState(3)
    has = rs.rand(64) > 0.05
    u = rs.rand(64).astype(np.float32)
    for cp in (0.1, 0.3, 0.0):
        got = handle_cfg(None, t(has), cp, u=t(u)).numpy()
        # the JAX rule on the same uniform draws
        hc = has.astype(np.float32)
        pct_without = 1.0 - hc.mean()
        frac = (cp - pct_without) / max(hc.mean(), 1e-8)
        want = has if (cp <= 0 or pct_without >= cp) else \
            has & ~((u <= frac) & has)
        np.testing.assert_array_equal(got, want)
    # with its own generator the dropped fraction lands near cfg_prob
    gen = torch.Generator().manual_seed(0)
    keep = handle_cfg(gen, torch.ones(4096, dtype=torch.bool), 0.25)
    assert abs((~keep).float().mean().item() - 0.25) < 0.03
    # and the JAX function keeps rows without controls unconditioned
    out = jax_handle_cfg(jax.random.key(0), jnp.asarray(has), 0.3)
    assert not np.any(np.asarray(out) & ~has)


def test_registry_and_draws_from_the_generator():
    assert get_model_cls("game_rft") is GameRFT
    assert get_core_cls("game_rft") is GameRFTCore
    from owl_audio_exps_tpu_torch.models.gamerft_audio import GameRFTAudio
    assert get_model_cls("game_rft_audio") is GameRFTAudio
    from owl_audio_exps_tpu_torch.models.gamemft_audio import GameMFTAudio
    assert get_model_cls("game_mft_audio") is GameMFTAudio
    with pytest.raises(ValueError, match="Invalid model id"):
        get_model_cls("no_such_model")
    _, pcfg = _configs()
    m = GameRFT(pcfg, dtype=torch.float32, device="cpu")
    x, mouse, btn = (t(a) for a in _video_inputs(
        np.random.RandomState(4), 2, 4, pcfg))
    a = m(x, mouse, btn, generator=torch.Generator().manual_seed(7))
    b = m(x, mouse, btn, generator=torch.Generator().manual_seed(7))
    c = m(x, mouse, btn, generator=torch.Generator().manual_seed(8))
    assert a.item() == b.item() != c.item()
    assert torch.isfinite(a)


# -------------------------------------------------------------- optimizer

def _jax_name(path) -> str:
    return ".".join(str(getattr(p, "key", p)) for p in path)


def _port_name(jax_name: str) -> str:
    import re
    name = re.sub(r"(blocks)_(\d+)", r"\1.\2", jax_name)
    return re.sub(r"\.(kernel|scale)$", ".weight", name)


def _ns5_float64(G):
    a, b, c = 3.4445, -4.7750, 2.0315
    X = G.astype(np.float64)
    tr = X.shape[0] > X.shape[1]
    X = X.T if tr else X
    X = X / (np.linalg.norm(X) + 1e-7)
    for _ in range(5):
        A = X @ X.T
        X = a * X + (b * A + c * A @ A) @ X
    return X.T if tr else X


@pytest.mark.parametrize("shape", [(48, 32), (32, 48), (32, 32)])
def test_ns5_matches_jax(shape):
    G = np.random.RandomState(5).randn(*shape).astype(np.float32)
    want = np.asarray(jax_ns5(jnp.asarray(G)).astype(jnp.float32))
    got = muon.zeropower_via_newtonschulz5(t(G)).float().numpy()
    assert got.shape == shape
    # five bf16 iterations: each side lies a few percent (relative
    # Frobenius) from the same iteration in float64, the JAX package's
    # and the port's bf16 roundings differ, so both are held to 8e-2 of
    # the float64 result and to 1e-1 of each other; both orthogonalize
    # (the quintic maps singular values into about [0.68, 1.13])
    ref = _ns5_float64(G)
    rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)
    assert rel(want, ref) < 8e-2 and rel(got, ref) < 8e-2
    assert rel(got, want) < 1e-1
    sv = np.linalg.svd(got, compute_uv=False)
    assert sv.min() > 0.5 and sv.max() < 1.3


@pytest.mark.parametrize("momentum_dtype", [None, "bfloat16"])
def test_muon_adamw_step_matches_jax(momentum_dtype):
    jcfg, pcfg = _configs()
    inputs = _video_inputs(np.random.RandomState(6), 1, 2, jcfg)
    _, params = jax_core(JaxGameRFT, jcfg, *inputs, rngs=MODEL_RNGS)
    params = jax.tree.map(lambda a: a, params["params"])
    rs = np.random.RandomState(7)
    grads = jax.tree.map(
        lambda a: jnp.asarray(rs.randn(*a.shape).astype(np.float32)), params)
    keys = ["core.proj_in", "core.proj_out.proj", "core.t_embed",
            "core.control_embed", "gate", "adaln"]
    kw = dict(lr=1e-3, momentum=0.95, adamw_lr=1e-3, adamw_wd=1e-4,
              adamw_eps=1e-15, adamw_betas=[0.9, 0.95], adamw_keys=keys,
              momentum_dtype=momentum_dtype)
    tx = jax_init_muon(params, **dict(
        kw, momentum_dtype=None if momentum_dtype is None else jnp.bfloat16))
    state = tx.init(params)
    new = params
    update = jax.jit(tx.update)
    for _ in range(2):
        upd, state = update(grads, state, new)
        new = optax.apply_updates(new, upd)

    model = carried(GameRFT, pcfg, {"params": params})
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    g_port = params_from_jax(numpy_params(grads), jcfg.n_heads)
    opt = muon.init_muon(model.named_parameters(), **kw)
    for _ in range(2):
        for name, p in model.named_parameters():
            p.grad = g_port[name].clone()
        opt.step()
    want = params_from_jax(numpy_params(new), jcfg.n_heads)
    for name, p in model.named_parameters():
        if opt.labels[name] == "muon":
            # NS5 runs in bf16 (see test_ns5_matches_jax): the two steps'
            # updates agree to 1e-1 relative
            d_port = (p.detach() - before[name]).numpy()
            d_jax = (want[name] - before[name]).numpy()
            assert np.linalg.norm(d_port - d_jax) < \
                1e-1 * np.linalg.norm(d_jax), name
        else:   # AdamW: the same arithmetic
            np.testing.assert_allclose(p.detach().numpy(),
                                       want[name].numpy(), atol=1e-6,
                                       rtol=1e-6, err_msg=name)

    # the labels agree parameter by parameter, and a stray key raises
    labels = jax.tree_util.tree_map_with_path(
        lambda path, lab: (_port_name(_jax_name(path)), lab),
        jax_labels(params, keys))
    flat = dict(jax.tree.leaves(labels, is_leaf=lambda x: isinstance(
        x, tuple)))
    assert flat == opt.labels
    assert set(flat.values()) == {"muon", "adamw"}
    with pytest.raises(ValueError, match="not found"):
        muon.muon_adamw_labels(model.named_parameters(), ["no_such_key"])
    if momentum_dtype:
        assert all(s["momentum"].dtype == torch.bfloat16
                   for s in opt.muon.state.values())
        assert all(s["mu"].dtype == torch.bfloat16
                   for s in opt.adamw.state.values())


def test_adamw_step_with_clipping_matches_optax():
    rs = np.random.RandomState(8)
    shapes = [(8, 6), (6,), (3, 4)]
    ps = [rs.randn(*s).astype(np.float32) for s in shapes]
    gs = [10 * rs.randn(*s).astype(np.float32) for s in shapes]
    # the JAX step: global-norm clip to 10, then optax.adamw
    gnorm = optax.global_norm([jnp.asarray(g) for g in gs])
    scale = jnp.minimum(1.0, 10.0 / (gnorm + 1e-6))
    tx = optax.adamw(1e-2, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.01)
    jp = [jnp.asarray(p) for p in ps]
    st = tx.init(jp)
    for _ in range(2):
        upd, st = tx.update([jnp.asarray(g) * scale for g in gs], st, jp)
        jp = optax.apply_updates(jp, upd)

    tp = [torch.nn.Parameter(t(p)) for p in ps]
    opt = muon.AdamW(tp, 1e-2, betas=(0.9, 0.99), eps=1e-8,
                     weight_decay=0.01)
    for _ in range(2):
        for p, g in zip(tp, gs):
            p.grad = t(g)
        norm = clip_grad_norm(tp, 10.0)
        opt.step()
    np.testing.assert_allclose(norm.item(), float(gnorm), rtol=1e-6)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------------ data

def test_synthetic_batches_match_jax(monkeypatch):
    kw = dict(window_length=4, channels=4, sample_size=2, n_buttons=3)
    want, got = iter(jax_loader("synthetic_latent", 2, **kw)), \
        iter(get_loader("synthetic_latent", 2, **kw))
    for _ in range(3):
        for a, b in zip(next(want), next(got)):
            np.testing.assert_array_equal(a, b)
    # the S3 loaders are ported and, without boto3, raise as JAX's do
    monkeypatch.setitem(sys.modules, "boto3", None)
    with pytest.raises(ImportError, match="boto3"):
        get_loader("cod_s3", 2, bucket_name="bucket")


# ----------------------------------------------------------------- remat

REMAT = {"off": dict(gradient_checkpointing=False),
         "block": dict(gradient_checkpointing=True),
         "group": dict(gradient_checkpointing=True,
                       remat_granularity="group")}


def _remat_model(mode, **kw):
    # tpf 64 and a window of 2 frames: the band route on local layers
    cfg = port_config(**dict(dict(
        TINY_VIDEO, n_layers=8, sample_size=8, tokens_per_frame=64,
        attn_impl="splash"), **REMAT[mode], **kw))
    model = GameRFT(cfg, dtype=torch.float32, device="cpu", seed=0)
    return cfg, model


def _loss_and_grads(model, x, mouse, btn):
    loss = model(x, mouse, btn, generator=torch.Generator().manual_seed(3))
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in
                         model.named_parameters()}


def test_remat_changes_neither_loss_nor_gradients():
    rs = np.random.RandomState(9)
    _, m0 = _remat_model("off")
    x, mouse, btn = (t(a) for a in _video_inputs(rs, 1, 4, m0.config))
    ref_loss, ref = _loss_and_grads(m0, x, mouse, btn)
    for mode in ("block", "group"):
        _, m = _remat_model(mode)
        loss, grads = _loss_and_grads(m, x, mouse, btn)
        assert loss == pytest.approx(ref_loss, rel=1e-6, abs=0)
        for n in ref:
            torch.testing.assert_close(grads[n], ref[n], atol=1e-6,
                                       rtol=1e-5)


@pytest.mark.parametrize("mode", list(REMAT))
def test_attention_forwards_per_step_count_the_remat(mode):
    cfg, model = _remat_model(mode)
    calls = {"band": 0, "splash": 0}
    orig = band.band_attention, splash.splash_attention

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    band.band_attention = counted("band", orig[0])
    splash.splash_attention = counted("splash", orig[1])
    try:
        x, mouse, btn = (t(a) for a in _video_inputs(
            np.random.RandomState(10), 1, 4, cfg))
        _loss_and_grads(model, x, mouse, btn)
    finally:
        band.band_attention, splash.splash_attention = orig
    per_layer = attention_forwards_per_step(cfg)
    flags = [i % 4 != 0 for i in range(cfg.n_layers)]
    assert calls["band"] == sum(f for f, l in zip(per_layer, flags) if l)
    assert calls["splash"] == sum(f for f, l in zip(per_layer, flags)
                                  if not l)
    assert per_layer == {"off": [1] * 8, "block": [2] * 8,
                         "group": [3, 3, 3, 2] * 2}[mode]


# the memory knobs, each on the port's kernel route (attn_impl splash: the
# plain versions on the CPU), where the JAX package takes it on the card
KNOBS = {
    "remat_sequenced": dict(gradient_checkpointing=True,
                            remat_granularity="group", remat_sequenced=True),
    "fused_head_chunks": dict(splash_head_chunks=2, fused_head_chunks=True),
    "mlp_chunks": dict(mlp_chunks=4),
}


@pytest.mark.parametrize("knob", list(KNOBS))
def test_memory_knobs_keep_the_loss_and_gradients(knob, monkeypatch):
    """Each knob on (tests/test_sequenced_remat.py's contract: the values
    of the plain run) against the same step with the knob off and against
    the JAX package with the knob (on the CPU its dense path, where the
    fused and sequenced forms do not engage), on the JAX model's weights
    and draws: loss rtol 1e-5 of JAX and 1e-6 of the plain port, gradients
    atol 1e-5 / rtol 1e-3 of JAX and atol 1e-6 / rtol 1e-5 of the plain
    port. The knob must engage: per-head-slice kernel calls, MLP chunks,
    per-block checkpoints (2 attention forwards a layer, not group's)."""
    from owl_audio_exps_tpu_torch.nn import layers

    over = dict(n_layers=4, n_heads=4, d_model=64, **KNOBS[knob])
    jcfg, pcfg = _configs(**over)
    pcfg.attn_impl = "splash"
    rs = np.random.RandomState(12)
    inputs = _video_inputs(rs, 2, 4, jcfg)
    model, params = jax_core(JaxGameRFT, jcfg, *inputs, rngs=MODEL_RNGS)
    jin = [jnp.asarray(a) for a in inputs]

    def loss_and_draw(p):
        out = model.apply(p, *jin, return_dict=True,
                          rngs={"noise": jax.random.key(6)})
        return out["diffusion_loss"], out

    (loss_j, draw), grads_j = jax.jit(jax.value_and_grad(
        loss_and_draw, has_aux=True))(params)
    draws = dict(ts=t(draw["ts"]), z=t(draw["z_video"]),
                 has_controls=t(draw["cfg_mask"]))

    calls = {"heads": [], "mlp": 0}
    orig = splash.splash_attention, band.band_attention, \
        layers.MLPCustom.forward

    def kernel(fn):
        def wrapped(q, *a, **kw):
            calls["heads"].append(q.shape[1])
            return fn(q, *a, **kw)
        return wrapped

    def mlp(self, x):
        calls["mlp"] += id(self) in block_mlps
        return orig[2](self, x)

    monkeypatch.setattr(splash, "splash_attention", kernel(orig[0]))
    monkeypatch.setattr(band, "band_attention", kernel(orig[1]))
    monkeypatch.setattr(layers.MLPCustom, "forward", mlp)
    port = carried(GameRFT, pcfg, params)
    block_mlps = {id(b.mlp) for b in port.core.transformer.blocks}
    loss_p = port(*(t(a) for a in inputs), **draws)
    loss_p.backward()
    np.testing.assert_allclose(loss_p.item(), float(loss_j), rtol=1e-5)
    want = params_from_jax(numpy_params(grads_j), jcfg.n_heads)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=1e-3, err_msg=name)
    n = pcfg.n_layers
    if knob == "fused_head_chunks":
        assert calls["heads"] == [2] * (2 * n)
    elif knob == "mlp_chunks":
        # 4 chunks a block, each recomputed by its checkpoint
        assert calls["mlp"] == 2 * 4 * n and calls["heads"] == [4] * n
    else:
        assert attention_forwards_per_step(pcfg) == [2] * n
        assert len(calls["heads"]) == 2 * n

    plain_cfg = port_config(**dict(TINY_VIDEO, n_layers=4, n_heads=4,
                                   d_model=64, attn_impl="splash"))
    plain = carried(GameRFT, plain_cfg, params)
    loss_0 = plain(*(t(a) for a in inputs), **draws)
    loss_0.backward()
    assert loss_p.item() == pytest.approx(loss_0.item(), rel=1e-6, abs=0)
    grads_0 = dict(plain.named_parameters())
    for name, p in port.named_parameters():
        torch.testing.assert_close(p.grad, grads_0[name].grad, atol=1e-6,
                                   rtol=1e-5)


def test_scan_layers_is_the_unrolled_model():
    """scan_layers stacks parameters for XLA's scan: the port runs the same
    layer loop, so the model is the unrolled one, key for key."""
    _, pcfg = _configs(scan_layers=True)
    _, plain = _configs()
    scanned = GameRFT(pcfg, device="cpu", seed=0).state_dict()
    unrolled = GameRFT(plain, device="cpu", seed=0).state_dict()
    assert set(scanned) == set(unrolled)
    for k in unrolled:
        torch.testing.assert_close(scanned[k], unrolled[k], atol=0, rtol=0)


def test_return_dict_and_cfg_prob_match_jax():
    """GameRFT(return_dict=True) against the JAX package's dict on its
    draws (every entry: rtol 1e-5, atol 1e-5), and cfg_prob overriding the
    config's in the dropout drawn from the generator."""
    jcfg, pcfg = _configs()
    rs = np.random.RandomState(13)
    inputs = _video_inputs(rs, 4, 4, jcfg)
    model, params = jax_core(JaxGameRFT, jcfg, *inputs, rngs=MODEL_RNGS)
    out = jax_apply(model, params, *inputs, return_dict=True, cfg_prob=0.5,
                    rngs={"noise": jax.random.key(8)})
    port = carried(GameRFT, pcfg, params)
    with torch.no_grad():
        got = port(*(t(a) for a in inputs), ts=t(out["ts"]),
                   z=t(out["z_video"]), has_controls=t(out["cfg_mask"]),
                   return_dict=True)
    assert set(got) == set(out)
    for key, value in out.items():
        np.testing.assert_allclose(got[key].float().numpy(),
                                   np.asarray(value, np.float32), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    # cfg_prob 1.0 drops every row's controls, 0.0 none
    x, mouse, btn = (t(a) for a in inputs)
    for cp, kept in ((1.0, 0), (0.0, 4)):
        d = port(x, mouse, btn, generator=torch.Generator().manual_seed(1),
                 return_dict=True, cfg_prob=cp)
        assert int(d["cfg_mask"].sum()) == kept


# --------------------------------------------------------------- trainer

def _train_config(tmp_path, **train):
    cfg = Config.from_dict({
        "model": dict(TINY_VIDEO, n_layers=4, gradient_checkpointing=True,
                      remat_granularity="group"),
        "train": dict(dict(
            trainer_id="rft", data_id="synthetic_latent",
            data_kwargs=dict(window_length=4, channels=4, sample_size=2,
                             n_buttons=3),
            target_batch_size=2, batch_size=1, opt="Muon",
            opt_kwargs=dict(lr=1e-3, momentum=0.95,
                            momentum_dtype="bfloat16", adamw_lr=1e-4,
                            adamw_keys=["core.proj_in", "gate", "adaln"]),
            scheduler=None, save_interval=2, sample_interval=1000,
            log_interval=1, sampler_id="av_caching",
            checkpoint_dir=str(tmp_path / "ckpt"),
            output_path=str(tmp_path / "export"), vae_scale=1.0), **train),
        "wandb": {"run_name": "test"}})
    return cfg


def _state_tensors(state):
    out = {f"p.{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"e.{k}": v for k, v in state.ema.items()})
    opt = state.optimizer.state_dict()
    for part, sd in opt.items():
        for idx, st in sd["state"].items():
            for k, v in st.items():
                out[f"o.{part}.{idx}.{k}"] = v
    return out


def test_trainer_trains_saves_and_resumes(tmp_path):
    cfg = _train_config(tmp_path)
    trainer = get_trainer_cls("rft")(cfg, device="cpu")
    state = trainer.train(max_steps=2)
    assert state.step == 2 and trainer.accum_steps() == 2
    losses = [h["diffusion_loss"] for h in trainer.logger.history]
    assert len(losses) == 2 and all(np.isfinite(losses))
    # the EMA moved away from the initial weights, towards the params
    init = trainer.init_state()
    moved = [(state.ema[n] - p).abs().max().item()
             for n, p in init.model.named_parameters()]
    assert max(moved) > 0
    assert (tmp_path / "ckpt" / "step_2.pt").exists()
    assert (tmp_path / "export" / "params.pt").exists()

    cfg.train.resume_ckpt = str(tmp_path / "ckpt" / "step_2.pt")
    resumed = get_trainer_cls("rft")(cfg, device="cpu")
    rstate = resumed.load(cfg.train.resume_ckpt, resumed.init_state(seed=9))
    assert rstate.step == 2
    want, got = _state_tensors(state), _state_tensors(rstate)
    assert set(want) == set(got)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0)
    # and training goes on from step 2
    assert resumed.train(max_steps=3).step == 3


def test_train_entry_point_runs_on_the_cpu_when_asked(tmp_path):
    import yaml
    from owl_audio_exps_tpu_torch.train import main
    cfg = _train_config(tmp_path, opt="AdamW", opt_kwargs=dict(lr=1e-3),
                        scheduler="cosine",
                        scheduler_kwargs=dict(total_steps=4, warmup_steps=1))
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    main(["--config_path", str(path), "--max_steps", "1", "--device", "cpu"])
    from owl_audio_exps_tpu_torch.models import get_model_cls
    assert get_trainer_cls("audio_vae").__name__ == "AudioVAETrainer"
    assert get_model_cls("game_mft_audio").__name__ == "GameMFTAudio"
    with pytest.raises(NotImplementedError, match="Muon"):
        get_trainer_cls("rft")(_train_config(
            tmp_path, scheduler="cosine",
            scheduler_kwargs=dict(total_steps=4)), device="cpu").init_state()
