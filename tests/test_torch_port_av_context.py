"""Context parallelism of the port's AV models (models/gamerft_audio.py,
models/gamemft_audio.py, nn/mmattn.py, parallel/context.py at the AV
tokens-per-frame) against the JAX package, on the CPU.

The JAX package shards any model's uncached attention over ``seq``
(nn/attn.py:311-330; the MMDiT's through the same function), so its AV
model under sequence parallelism computes what it computes without it:
the port's ranks are held against JAX's AV model at the same weights and
draws. The cases run in one 4-rank gloo world (tests/torch_sp_workers.py):
{seq 2} (two data ranks, each taking the whole batch) and {seq 4} on the
``dit``, ``uvit`` and ``mmdit`` backbones (2 layers, tpf 5, 8 frames, a
2-frame window: 2 and 4 frames a rank, the halo one window) and an
AVRFTTrainer step at {seq 2} against one process; MeanFlow at {seq 2}
runs in a 2-rank world.
Tolerances: predictions and losses atol 1e-4 (fp32; the ring's merge and
the halo reassociate), gradients atol 1e-4 rtol 1e-3; MeanFlow as
tests/test_torch_port_meanflow.py (losses rtol 1e-4, gradients atol
1e-5 rtol 1e-3); the trainer step against one process loss rtol 1e-5,
gradients atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_audio_exps_tpu.configs import transformer_config as jax_config
from owl_audio_exps_tpu.models.gamerft_audio import \
    GameRFTAudio as JaxGameRFTAudio
from owl_audio_exps_tpu_torch.configs import Config
from owl_audio_exps_tpu_torch.configs import transformer_config as port_config
from owl_audio_exps_tpu_torch.models.gamemft_audio import GameMFTAudio
from owl_audio_exps_tpu_torch.parallel import context
from owl_audio_exps_tpu_torch.utils.weights import params_from_jax

import test_torch_port_meanflow as mf
import torch_sp_workers as workers
from torch_port_util import (MODEL_RNGS, TINY_AV, av_inputs, jax_core,
                             numpy_params)

AV = dict(TINY_AV, causal=True, n_buttons=3)
BACKBONES = ("dit", "uvit", "mmdit")
SEQS = (2, 4)


def _port_sd(params, n_heads):
    return {k: v.numpy() for k, v in
            params_from_jax(numpy_params(params), n_heads).items()}


def _jax_av(backbone):
    """JAX's AV model: weights, batch, draws, its dict and gradients."""
    cfg = jax_config(**dict(AV, backbone=backbone))
    rs = np.random.RandomState(7)
    x, a, _, m, b = av_inputs(rs, 2, 8, cfg)
    batch = tuple(np.asarray(v, np.float32) for v in (x, a, m, b))
    jin = [jnp.asarray(v) for v in batch]
    model, params = jax_core(JaxGameRFTAudio, cfg, *batch, rngs=MODEL_RNGS)

    def loss_and_draw(p):
        out = model.apply(p, *jin, return_dict=True,
                          rngs={"noise": jax.random.key(5)})
        return out["diffusion_loss"], out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss_and_draw, has_aux=True))(params)
    out = {k: np.asarray(v) for k, v in out.items()}
    draws = dict(ts=out["ts"].astype(np.float32),
                 z_video=out["z_video"].astype(np.float32),
                 z_audio=out["z_audio"].astype(np.float32),
                 has_controls=out["cfg_mask"])
    return dict(sd=_port_sd(params, cfg.n_heads), batch=batch, draws=draws,
                out=out, grads=_port_sd(grads, cfg.n_heads))


def _jax_meanflow():
    batch = mf._data(n=8)
    model, params = jax_core(mf.JaxGameMFTAudio, jax_config(**mf.MFT),
                             *batch, rngs=MODEL_RNGS)
    key = jax.random.key(3)
    draws = mf._jax_draws(model, params, batch, key)
    jin = [jnp.asarray(a) for a in batch]

    def loss_fn(p):
        loss, lv, la = model.apply({"params": p}, *jin, rngs={"noise": key})
        return loss, (lv, la)

    (jl, (jlv, jla)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params["params"])
    port = GameMFTAudio(port_config(**mf.MFT), dtype=torch.float32,
                        device="cpu", seed=None)
    ts, rs = port.sample_timesteps(2, 8, u=draws["u"], pair=draws["pair"])
    d = dict(ts=ts.numpy(), rs=rs.numpy(),
             z_video=draws["z_video"].numpy(),
             z_audio=draws["z_audio"].numpy(),
             has_controls=draws["has_controls"].numpy())
    return dict(sd=_port_sd(params, mf.MFT["n_heads"]), batch=batch,
                draws=d, losses=[float(jl), float(jlv), float(jla)],
                grads=_port_sd({"params": jgrads}, mf.MFT["n_heads"]))


def _train_cfg(tmp, mesh):
    return Config.from_dict({
        "model": dict(AV, backbone="dit",
                      sequence_parallel=mesh.get("seq", 1) > 1),
        "train": {"trainer_id": "av", "data_id": "synthetic_av",
                  "target_batch_size": 2, "batch_size": 2 // (
                      2 if mesh.get("seq") == 2 else 1),
                  "opt": "AdamW", "opt_kwargs": {"lr": 1e-4, "eps": 1e-4},
                  "mesh": mesh, "checkpoint_dir": str(tmp / "ckpt"),
                  "vae_scale": 1.0, "save_interval": 100,
                  "sample_interval": 100}}).to_dict()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("avsp")
    refs, jobs = {}, []
    for backbone in BACKBONES:
        refs[backbone] = ref = _jax_av(backbone)
        for n in SEQS:
            jobs.append((f"{backbone}{n}", "av_sp", (
                "game_rft_audio", dict(AV, backbone=backbone), ref["sd"],
                ref["batch"], ref["draws"], {"seq": n})))
    # the trainer step: the dit model's weights, batch and draws
    ref = refs["dit"]
    d = ref["draws"]
    draws = (d["has_controls"].astype(np.float32), d["ts"], d["z_video"],
             d["z_audio"])
    step_args = (ref["sd"], ref["batch"], draws)
    jobs.append(("step", "av_train_step", (_train_cfg(tmp, {"seq": 2}),
                                           *step_args)))
    # a seq axis without sequence parallelism: every seq rank the whole
    # loss (replicated over seq, as the JAX package's batch sharding)
    no_sp = _train_cfg(tmp, {"seq": 2})
    no_sp["model"]["sequence_parallel"] = False
    jobs.append(("step_no_sp", "av_train_step", (no_sp, *step_args)))
    # MeanFlow at {seq 2} (every data rank takes the whole batch)
    refs["mft"] = ref = _jax_meanflow()
    jobs.append(("mft2", "av_sp", ("game_mft_audio", mf.MFT, ref["sd"],
                                   ref["batch"], ref["draws"], {"seq": 2})))
    res = workers.run_ranks(workers.run_jobs, 4, tmp / "ranks", jobs)
    one = workers.av_train_step(_train_cfg(tmp, {}), *step_args)
    return dict(res=res, refs=refs, one=one)


def _seq_group(res, case):
    """The ranks of data index 0, in seq order."""
    got = [r[case] for r in res if r[case]["data_index"] == 0]
    return sorted(got, key=lambda r: r["seq_index"])


@pytest.mark.parametrize("n", SEQS)
@pytest.mark.parametrize("backbone", BACKBONES)
def test_av_model_under_sp_matches_jax(backbone, n, world):
    ref = world["refs"][backbone]
    group = _seq_group(world["res"], f"{backbone}{n}")
    assert len(group) == n
    assert [g["frames"] for g in group] == [
        (i * 8 // n, (i + 1) * 8 // n) for i in range(n)]
    for key in ("pred_video", "pred_audio"):
        got = np.concatenate([g[key] for g in group], axis=1)
        np.testing.assert_allclose(got, ref["out"][key], atol=1e-4,
                                   rtol=1e-4, err_msg=key)
    for i, key in enumerate(("diffusion_loss", "video_loss", "audio_loss")):
        np.testing.assert_allclose(sum(g["losses"][i] for g in group),
                                   float(ref["out"][key]), atol=1e-4,
                                   rtol=1e-4, err_msg=key)
    for g in group:     # every seq rank ends with the whole gradient
        assert set(g["grads"]) == set(ref["grads"])
        for name, want in ref["grads"].items():
            np.testing.assert_allclose(g["grads"][name], want, atol=1e-4,
                                       rtol=1e-3, err_msg=name)


def test_meanflow_under_sp_matches_jax(world):
    """MeanFlow's jvp through the ring and the halo (their exchanges carry
    the tangents; the plain partials on the CPU, as JAX's
    _partial_attn_dense), the CFG rows chosen over every frame."""
    ref = world["refs"]["mft"]
    group = _seq_group(world["res"], "mft2")
    for i in range(3):
        np.testing.assert_allclose(sum(g["losses"][i] for g in group),
                                   ref["losses"][i], rtol=1e-4)
    for g in group:
        for name, want in ref["grads"].items():
            np.testing.assert_allclose(g["grads"][name], want,
                                       atol=mf.GRAD_ATOL, rtol=mf.GRAD_RTOL,
                                       err_msg=name)


@pytest.mark.parametrize("case", ["step", "step_no_sp"])
def test_av_trainer_step_under_sp_matches_one_process(case, world):
    """AVRFTTrainer.train_step at {seq 2} (two data ranks of one batch row
    each; every seq rank takes its rows' frames) against one process; and
    on the same mesh without sequence parallelism, where every seq rank
    computes its rows' whole loss."""
    one = world["one"]
    for r in world["res"]:
        got = r[case]
        assert got["mesh"] == (2, 2)
        for k, v in one["losses"].items():
            np.testing.assert_allclose(got["losses"][k], v, rtol=1e-5,
                                       err_msg=k)
        for name, g in one["grads"].items():
            np.testing.assert_allclose(got["grads"][name], g, atol=1e-5,
                                       rtol=0, err_msg=name)


def test_halo_band_routes_as_the_unsplit_layer():
    """The card's band over [halo | slice]: K5 with plan (520, 2) at the AV
    model's tpf 65 (26,000 and 24,960 tokens, window 16), as the unsplit
    layer at 99,840 tokens; K2 at dit_v4's frame-exact tpf 64."""
    from owl_audio_exps_tpu_torch.nn.attn import attention_route
    cfg = Config.from_dict({"model": dict(AV, tokens_per_frame=65,
                                          local_window=16)}).model
    assert attention_route(cfg, True, 99840) == ("band2", (520, 2))
    for L in (26000, 24960):
        assert context.halo_band_route(L, 65, 16) == ("band2", (520, 2))
    assert context.halo_band_route(25600, 64, 16) == ("band", None)


def test_mmdit_v2_windows_under_sp_are_refused_in_both_packages():
    """configs/mmdit_v2.yml under sequence parallelism: its 1,000-frame
    training window over 2 or 4 ranks leaves slices of 500 or 250 frames,
    which neither its 16-frame local nor its 256-frame global window
    divides; JAX's halo needs the slice to be a multiple of the window's
    span (ops/local.py:95), so both packages refuse every layer there
    (ROADMAP Queue 3, a reference behaviour)."""
    from owl_audio_exps_tpu.ops import local as jax_local
    cfg = Config.from_yaml("configs/mmdit_v2.yml")
    tpf, frames = cfg.model.tokens_per_frame, cfg.train.data_kwargs[
        "window_length"]
    windows = (cfg.model.local_window, cfg.model.global_window)
    assert (tpf, frames, windows) == (65, 1000, (16, 256))
    for n in (2, 4):
        L_loc = frames // n * tpf
        for window in windows:
            C = window * tpf
            assert L_loc % C
            q = jnp.zeros((1, 1, L_loc, 4))
            with pytest.raises(AssertionError):
                jax_local.chunked_local_attention(
                    q, q, q, tpf, window, halo_kv=(q[:, :, :C],) * 2,
                    halo_valid=jnp.asarray(True))
            with pytest.raises(ValueError, match="multiple of the window"):
                context.sp_local_attention(
                    *(torch.zeros(1, 1, L_loc, 4) for _ in range(3)), tpf,
                    window)
