"""The port's distillation trainers (trainers/{distill_common,causvid,
ode_distill}.py) against the JAX package's, on the CPU at
tests/test_distill.py's tiny width (2 layers, d 32, tpf 4, 8 frames,
local_window 2).

Both sides run float32 cores on the same weights (the JAX trainer's
params carried over by ``params_from_jax``, the critic initialised apart
from the student so the two differ) and the same batch; the port gets the
JAX losses' draws, replayed from the same key splits. Tolerances: losses
rtol 1e-5; gradients atol 1e-5, rtol 1e-3 (float32 reassociation);
parameters, optimizer moments and EMA after a step atol 1e-6. The losses
round the latents and the noised inputs to bfloat16 at the same points in
both packages, so the tolerances above hold as long as no float32
difference crosses a bfloat16 rounding boundary; the inputs here are the
ones checked to keep to them.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from owl_audio_exps_tpu.configs import Config as JaxConfig
from owl_audio_exps_tpu.models.gamerft import GameRFTCore as JaxCore
from owl_audio_exps_tpu.trainers import get_trainer_cls as jax_trainer_cls
from owl_audio_exps_tpu.trainers.distill_common import (
    build_simple_opt as jax_simple_opt)
from owl_audio_exps_tpu.trainers.distill_common import (
    sample_discrete_ts as jax_discrete_ts)
from owl_audio_exps_tpu.trainers.ode_distill import (
    prune_layer_indices as jax_prune_indices)
from owl_audio_exps_tpu.trainers.ode_distill import (
    transfer_pruned_params as jax_transfer)
from owl_audio_exps_tpu.utils.checkpoints import (
    save_clean_export as jax_export)
from owl_audio_exps_tpu.utils.checkpoints import wait_for_checkpoints
from owl_audio_exps_tpu_torch.configs import Config
from owl_audio_exps_tpu_torch.models.gamerft import GameRFTCore
from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
from owl_audio_exps_tpu_torch.trainers.causvid import (CausVidTrainer,
                                                       LossDraws,
                                                       RolloutDraws)
from owl_audio_exps_tpu_torch.trainers.distill_common import (
    build_simple_opt, lerp_batched, zlerp_batched)
from owl_audio_exps_tpu_torch.trainers.ode_distill import (
    DistillODETrainer, ODEDraws, prune_layer_indices, transfer_pruned_params)
from owl_audio_exps_tpu_torch.trainers.self_forcing import SelfForceTrainer
from owl_audio_exps_tpu_torch.utils.checkpoints import (save_clean_export,
                                                        unwrap_core,
                                                        versatile_load)
from owl_audio_exps_tpu_torch.utils.weights import params_from_jax

from torch_port_util import (LOSS_RTOL, assert_grads, assert_params, batch,
                             jax_example_args, jax_init, numpy_params, raw_cfg,
                             t, trainers)

def causvid_draws(key, shape) -> LossDraws:
    """The draws of the JAX critic / DMD loss under ``key``: split 3 ->
    (rollout, ts, z); the rollout's split 3 -> (mask, grid ts, noise)."""
    b, n = shape[:2]
    r_roll, r_ts, r_z = jax.random.split(key, 3)
    r_mask, r_gts, r_noise = jax.random.split(r_roll, 3)
    rollout = RolloutDraws(
        gen_mask=t(jax.random.uniform(r_mask, (b, n)) < 0.25),
        ts=t(jax_discrete_ts(r_gts, (b, n))),
        z=t(jax.random.normal(r_noise, shape, jnp.float32)))
    return LossDraws(rollout,
                     t(jax.nn.sigmoid(jax.random.normal(r_ts, (b, n)))),
                     t(jax.random.normal(r_z, shape, jnp.float32)))


# ------------------------------------------------------------- helpers

def test_noising_helpers_match_jax():
    from owl_audio_exps_tpu.trainers.distill_common import (
        lerp_batched as jax_lerp)
    rs = np.random.RandomState(0)
    x = rs.randn(2, 3, 4, 2, 2).astype(np.float32)
    z = rs.randn(2, 3, 4, 2, 2).astype(np.float32)
    ts = rs.rand(2, 3).astype(np.float32)
    want = jax_lerp(jnp.asarray(x), jnp.asarray(z), jnp.asarray(ts))
    got = lerp_batched(t(x), t(z), t(ts))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=0)
    np.testing.assert_allclose(zlerp_batched(t(x), t(ts), t(z)).numpy(),
                               np.asarray(want[0]), atol=1e-6, rtol=0)


def test_build_simple_opt_matches_optax_and_refuses_muon():
    """AdamW and Adam step as optax does; Muon (dit_v4_prune.yml's
    ``opt``) raises ValueError in both packages."""
    import optax
    rs = np.random.RandomState(1)
    p0 = rs.randn(6, 5).astype(np.float32)
    g = rs.randn(6, 5).astype(np.float32)
    for name, kw in (("AdamW", dict(lr=1e-2, weight_decay=0.1)),
                     ("adam", dict(lr=1e-2, betas=(0.8, 0.9), eps=1e-6))):
        tx = jax_simple_opt(name, dict(kw))
        jp = jnp.asarray(p0)
        st = tx.init(jp)
        param = torch.nn.Parameter(t(p0))
        opt = build_simple_opt(name, dict(kw), [param])
        for _ in range(2):
            upd, st = tx.update(jnp.asarray(g), st, jp)
            jp = optax.apply_updates(jp, upd)
            param.grad = t(g)
            opt.step()
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp),
                                   atol=1e-6, rtol=1e-6)
    for opt_name in ("Muon", "sgd"):
        with pytest.raises(ValueError, match="Unsupported distill"):
            jax_simple_opt(opt_name, {})
        with pytest.raises(ValueError, match="Unsupported distill"):
            build_simple_opt(opt_name, {}, [torch.nn.Parameter(t(p0))])


def test_registry():
    assert get_trainer_cls("causvid_vid") is CausVidTrainer
    assert get_trainer_cls("sforce_vid") is SelfForceTrainer
    assert get_trainer_cls("ode_distill_vid") is DistillODETrainer
    for trainer_id in ("causvid_vid", "sforce_vid", "ode_distill_vid"):
        assert jax_trainer_cls(trainer_id).__name__ == \
            get_trainer_cls(trainer_id).__name__
    assert get_trainer_cls("audio_vae").__name__ == \
        jax_trainer_cls("audio_vae").__name__ == "AudioVAETrainer"
    from owl_audio_exps_tpu_torch.models import get_model_cls
    assert get_model_cls("game_mft_audio").__name__ == "GameMFTAudio"
    with pytest.raises(ValueError, match="Invalid trainer id"):
        get_trainer_cls("causvid")


def test_versatile_load_and_unwrap_core(tmp_path):
    """EMA first, then params, then the whole object; a clean export's
    directory; a wrapper's ``core.`` prefix stripped."""
    from owl_audio_exps_tpu_torch.utils.checkpoints import save_checkpoint
    a, b = {"w": torch.ones(2)}, {"w": torch.zeros(2)}
    save_checkpoint(str(tmp_path / "both.pt"), {"params": a,
                                                "ema_params": b})
    save_checkpoint(str(tmp_path / "params.pt"), {"params": a})
    save_checkpoint(str(tmp_path / "bare.pt"), a)
    assert torch.equal(versatile_load(str(tmp_path / "both.pt"))["w"],
                       b["w"])
    assert torch.equal(versatile_load(str(tmp_path / "params.pt"))["w"],
                       a["w"])
    assert torch.equal(versatile_load(str(tmp_path / "bare.pt"))["w"],
                       a["w"])
    save_clean_export(str(tmp_path / "export"), b)
    assert torch.equal(versatile_load(str(tmp_path / "export"))["w"],
                       b["w"])
    wrapped = {"core.proj_in.weight": torch.ones(1), "extra": torch.ones(1)}
    assert list(unwrap_core(wrapped)) == ["proj_in.weight"]
    assert unwrap_core(a) is a


# -------------------------------------------------------------- losses

@pytest.mark.parametrize("loss", ["critic", "dmd"])
def test_critic_and_dmd_losses_match_jax(tmp_path, loss):
    """CausVid's critic loss (gradients w.r.t. the critic) and DMD loss
    (w.r.t. the student, through the one-call rollout) on JAX's draws."""
    jtr, js, ptr, ps = trainers(tmp_path, "causvid_vid")
    vid, mouse, btn = batch(3)
    jb = tuple(jnp.asarray(a) for a in (vid, mouse, btn))
    pb = [t(a) for a in (vid, mouse, btn)]
    key = jax.random.key(5)
    draws = causvid_draws(key, vid.shape)
    assert draws.rollout.gen_mask.any() and not draws.rollout.gen_mask.all()

    if loss == "critic":
        (jl, jm), jg = jax.jit(jax.value_and_grad(
            lambda cp: jtr.critic_loss(cp, js.student_params, jb, key),
            has_aux=True))(js.critic_params)
        pl, pm = ptr.critic_loss(ps.critic, ps.student, pb, draws)
        graded, frozen = ps.critic, ps.student
    else:
        (jl, jm), jg = jax.jit(jax.value_and_grad(
            lambda sp: jtr.dmd_loss(sp, js.critic_params, jb, key),
            has_aux=True))(js.student_params)
        pl, pm = ptr.dmd_loss(ps.student, ps.critic, pb, draws)
        graded, frozen = ps.student, ps.critic
    pl.backward()
    np.testing.assert_allclose(pl.item(), float(jl), rtol=LOSS_RTOL)
    for k, v in jm.items():
        np.testing.assert_allclose(pm[k].item(), float(v), rtol=LOSS_RTOL,
                                   err_msg=k)
    assert_grads(graded.named_parameters(), jg)
    assert all(p.grad is None for p in frozen.parameters())
    assert all(p.grad is None for p in ptr.teacher.parameters())


def test_critic_and_student_steps_match_jax(tmp_path):
    """One critic step, then one student step (AdamW, clip 10, EMA 0.99)
    against the JAX trainer's jitted steps: parameters, optimizer moments
    and EMA. AdamW's eps is 1e-4 here: its first step moves a parameter
    by lr g / (|g| + eps), which turns a float32 reassociation difference
    dg in a gradient near eps into up to lr dg / eps; at eps 1e-4 that
    stays below the states' 1e-6."""
    opt = {"lr": 1e-3, "eps": 1e-4}
    jtr, js, ptr, ps = trainers(tmp_path, "causvid_vid", opt_kwargs=opt,
                                d_opt_kwargs=dict(opt, lr=2e-3))
    vid, mouse, btn = batch(4)
    stack = [jnp.asarray(a)[None] for a in (vid, mouse, btn)]
    pb = [t(a) for a in (vid, mouse, btn)]
    critic_step, student_step = jtr.make_steps(1)
    kc, ks = jax.random.key(6), jax.random.key(7)
    # accum 1: the micro-batch's key is split(key, 1)[0]
    dc = causvid_draws(jax.random.split(kc, 1)[0], vid.shape)
    dstud = causvid_draws(jax.random.split(ks, 1)[0], vid.shape)

    js, jm = critic_step(js, stack, kc)
    pm = ptr.critic_step(ps, [pb], [dc])
    np.testing.assert_allclose(pm["critic_loss"].item(),
                               float(jm["critic_loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(pm["critic_grad_norm"].item(),
                               float(jm["critic_grad_norm"]), rtol=1e-4)
    assert_params(ps.critic.named_parameters(), js.critic_params,
                  what="critic ")

    js, jm = student_step(js, stack, ks)
    pm = ptr.student_step(ps, [pb], [dstud])
    assert ps.step == int(js.step) == 1
    np.testing.assert_allclose(pm["dmd_loss"].item(), float(jm["dmd_loss"]),
                               rtol=LOSS_RTOL)
    assert_params(ps.student.named_parameters(), js.student_params,
                  what="student ")
    assert_params(ps.student_ema.items(), js.student_ema, what="ema ")
    for opt, jopt, core in ((ps.critic_opt, js.critic_opt, ps.critic),
                            (ps.student_opt, js.student_opt, ps.student)):
        adam = jopt[0]
        assert int(adam.count) == 1
        for moment in ("mu", "nu"):
            assert_params(
                [(n, opt.state[p][moment])
                 for n, p in core.named_parameters()],
                getattr(adam, moment), what=f"{moment} ")


def ode_draws(key, shape, n_steps, subsample):
    r_init, r_keep = jax.random.split(key)
    return ODEDraws(
        t(jax.random.normal(r_init, shape, jnp.float32)),
        t(jax.random.uniform(r_keep, (n_steps,)) < subsample))


def test_ode_loss_matches_jax(tmp_path):
    """The teacher's 3-step guided trajectory and the student's weighted
    regression, the steps stacked on the batch axis (B 6 against JAX's
    vmap). The config also names dit_v4_prune.yml's rollout_steps,
    cfg_scale and gen_p, which the trainer ignores in both packages."""
    jtr, js, ptr, ps = trainers(
        tmp_path, "ode_distill_vid", ode_steps=3, subsample=0.5,
        rollout_steps=16, cfg_scale=1.5, gen_p=0.25)
    vid, mouse, btn = batch(8)
    jb = tuple(jnp.asarray(a) for a in (vid, mouse, btn))
    key = jax.random.key(9)
    draws = ode_draws(key, vid.shape, 3, 0.5)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda sp: jtr.ode_loss(sp, jb, key), has_aux=True))(
        js.student_params)
    pl, _ = ptr.ode_loss(ps.student, [t(a) for a in (vid, mouse, btn)],
                         draws)
    pl.backward()
    np.testing.assert_allclose(pl.item(), float(jl), rtol=LOSS_RTOL)
    assert_grads(ps.student.named_parameters(), jg)
    pb = [t(a) for a in (vid, mouse, btn)]
    ptr.train_cfg.merge(dict(rollout_steps=1, cfg_scale=1.0, gen_p=0.0))
    with torch.no_grad():
        assert ptr.ode_loss(ps.student, pb, draws)[0].item() == pl.item()

    # step 0 is kept even when the draw drops it
    dropped = ODEDraws(draws.x, torch.zeros(3, dtype=torch.bool))
    ps.student.zero_grad(set_to_none=True)
    with torch.no_grad():
        l0, _ = ptr.ode_loss(ps.student, pb, dropped)
    assert torch.isfinite(l0) and l0 > 0


# ---------------------------------------------------------------- prune

def test_prune_layer_indices_match_jax():
    for n_t, n_s in ((8, 4), (4, 4), (36, 16), (16, 8), (5, 2)):
        assert prune_layer_indices(n_t, n_s) == jax_prune_indices(n_t, n_s)
    with pytest.raises(ValueError):
        prune_layer_indices(4, 1)


def _teacher(tmp_path, n_layers=4):
    """A 4-layer JAX teacher: its config file and params."""
    tcfg = JaxConfig.from_dict(raw_cfg(tmp_path, "ode_distill_vid",
                                       model=dict(n_layers=n_layers)))
    path = tmp_path / "teacher.yml"
    path.write_text(yaml.safe_dump(tcfg.to_dict()))
    _, params = jax_init(JaxCore(tcfg.model, dtype=jnp.float32),
                         *jax_example_args(tcfg.model), rngs=3)
    return str(path), params["params"]


def test_transfer_pruned_params_matches_jax(tmp_path):
    _, params = _teacher(tmp_path)
    want = params_from_jax(numpy_params(jax_transfer(params, 4, 2)), 2)
    teacher = params_from_jax(numpy_params(params), 2)
    got = transfer_pruned_params(teacher, 4, 2)
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    assert not any(".blocks.2." in n or ".blocks.3." in n for n in got)


def test_pruned_init_from_a_saved_teacher_matches_jax(tmp_path):
    """teacher_ckpt read through versatile_load (the JAX trainer from an
    orbax export, the port from ``save_clean_export``'s directory): the
    2-layer student starts from teacher blocks 0 and 3, and its EMA with
    it. A ``student_ckpt`` of the 4-layer teacher (dit_v4_prune.yml
    names the 16-layer export for its 8-layer student) fails in both
    packages, with ValueError."""
    tpath, params = _teacher(tmp_path)
    jax_export(str(tmp_path / "jax_export"), params)
    wait_for_checkpoints()
    save_clean_export(str(tmp_path / "port_export"),
                      params_from_jax(numpy_params(params), 2))
    extra = dict(teacher_cfg=tpath, ode_steps=2)
    jtr = jax_trainer_cls("ode_distill_vid")(JaxConfig.from_dict(raw_cfg(
        tmp_path, "ode_distill_vid",
        teacher_ckpt=str(tmp_path / "jax_export"), **extra)))
    js = jtr.init_distill_state(jtr.example_args())
    ptr = get_trainer_cls("ode_distill_vid")(Config.from_dict(raw_cfg(
        tmp_path, "ode_distill_vid",
        teacher_ckpt=str(tmp_path / "port_export"), **extra)), device="cpu")
    ps = ptr.init_distill_state()
    assert ptr.teacher_cfg.n_layers == 4 and len(ps.student.transformer
                                                 .blocks) == 2
    for name, p in ptr.teacher.named_parameters():
        assert not p.requires_grad, name
    assert_params(ps.student.named_parameters(), js.student_params,
                  what="student ")
    assert_params(ps.student_ema.items(), js.student_ema, what="ema ")

    for trainer, export in ((jtr, "jax_export"), (ptr, "port_export")):
        trainer.train_cfg.student_ckpt = str(tmp_path / export)
    with pytest.raises(ValueError, match="tree prefix"):
        jtr.init_distill_state(jtr.example_args())
    with pytest.raises(ValueError, match="does not fit the 2-layer core"):
        ptr.init_distill_state()


# ------------------------------------------------- reference behaviours

def test_av_models_fail_in_both_packages(tmp_path):
    """causvid.yml and av_v5_8x8_sf.yml name game_rft_audio, whose core
    takes (x, audio, t, ...): the JAX trainers fail while initialising
    (AttributeError, the core reading mouse as its btn); the port refuses
    the config before any work."""
    av = dict(model_id="game_rft_audio", audio_channels=4,
              tokens_per_frame=5, has_audio=True)
    for trainer_id in ("causvid_vid", "sforce_vid"):
        raw = raw_cfg(tmp_path, trainer_id, model=av)
        jtr = jax_trainer_cls(trainer_id)(JaxConfig.from_dict(raw))
        with pytest.raises(AttributeError):
            jtr.init_distill_state(jtr.example_args())
        with pytest.raises(ValueError, match="video-only"):
            get_trainer_cls(trainer_id)(Config.from_dict(raw), device="cpu")
    for trainer_id in ("causvid_vid", "sforce_vid", "ode_distill_vid"):
        trainer = get_trainer_cls(trainer_id)(Config.from_dict(raw_cfg(
            tmp_path, trainer_id, opt="Muon")), device="cpu")
        with pytest.raises(ValueError, match="Unsupported distill"):
            trainer.init_distill_state()


# ------------------------------------------------------------------ CLI

@pytest.mark.parametrize("trainer_id", ["causvid_vid", "sforce_vid",
                                        "ode_distill_vid"])
def test_cli_trains_saves_and_reads_back(tmp_path, capsys, trainer_id):
    """``python -m owl_audio_exps_tpu_torch.train --device cpu`` on a tiny
    distill config whose loaders are the unported ``cod``: the cuts are
    printed, the eval (av_caching, 2 steps at [1.0, 0.5]) samples, and the
    checkpoint and the export read back through versatile_load into a
    core."""
    from owl_audio_exps_tpu_torch.train import main
    raw = raw_cfg(
        tmp_path, trainer_id, data_id="cod",
        data_kwargs=dict(window_length=4, dataset_path="/nonexistent"),
        sample_data_id="cod", sample_data_kwargs=dict(window_length=4),
        save_interval=1, sample_interval=1, log_interval=1, ode_steps=2,
        output_path=str(tmp_path / "export"), sampler_id="av_caching",
        sampler_kwargs=dict(n_steps=2, cfg_scale=1.0, num_frames=2,
                            noise_prev=0.2, custom_schedule=[1.0, 0.5]),
        update_ratio=1)
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(raw))
    main(["--config_path", str(path), "--max_steps", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] cut: data_id 'cod' -> 'synthetic_latent'" in out
    assert "sample_data_id 'cod'" in out and "sampler_id" not in out
    if trainer_id != "ode_distill_vid":
        assert "eval/latent_std=" in out
    step = torch.load(str(tmp_path / "ckpt" / "step_1.pt"),
                      weights_only=True)
    assert step["step"] == 1
    assert {"params", "ema_params", "opt_state", "critic",
            "critic_opt"} <= set(step)
    ema = versatile_load(str(tmp_path / "ckpt" / "step_1.pt"))
    export = versatile_load(str(tmp_path / "export"))
    assert set(ema) == set(export) == set(step["params"])
    core = GameRFTCore(Config.from_dict(raw).model, dtype=torch.float32,
                       device="cpu", seed=None)
    core.load_state_dict(unwrap_core(export), strict=True)
    for name, p in core.named_parameters():
        assert torch.equal(p, ema[name]), name
    assert os.path.exists(tmp_path / "export" / "params.pt")
