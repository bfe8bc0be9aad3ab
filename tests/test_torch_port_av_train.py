"""The port's causal AV training path (GameRFTAudio, AVRFTTrainer,
MixedAVRFTTrainer, the port cuts of train.py) against the JAX package, on
the CPU.

Weights are carried from the JAX package with ``params_from_jax`` (every
key must match, ``strict=True``); inputs are numpy from a seed or the
synthetic loaders, which draw the same stream in both packages; the
noise is the JAX model's own draw (``return_dict``), handed to the port.
Both run in float32; the model test routes the port's local layers
through band2 (``attn_impl: splash`` on the CPU runs the kernels' plain
versions), the JAX package takes its dense path on the CPU. Tolerances:
losses and metrics rtol 1e-5, gradients atol 1e-5 / rtol 1e-3 (float32
reassociation), AdamW steps atol 1e-6 (the same arithmetic on gradients
that agree to float32 rounding; eps 1e-2 keeps the first step's update a
smooth function of the gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_audio_exps_tpu.configs import Config as JaxConfig
from owl_audio_exps_tpu.configs import transformer_config as jax_config
from owl_audio_exps_tpu.data.synthetic import get_loader as jax_loader
from owl_audio_exps_tpu.models.gamerft_audio import \
    GameRFTAudio as JaxGameRFTAudio
from owl_audio_exps_tpu.trainers import get_trainer_cls as jax_trainer_cls
from owl_audio_exps_tpu.trainers.rft_trainer import _stack_accum
from owl_audio_exps_tpu_torch.configs import Config
from owl_audio_exps_tpu_torch.configs import transformer_config as port_config
from owl_audio_exps_tpu_torch.data import get_loader
from owl_audio_exps_tpu_torch.models import get_model_cls
from owl_audio_exps_tpu_torch.models.gamerft_audio import GameRFTAudio
from owl_audio_exps_tpu_torch.nn.attn import attention_route
from owl_audio_exps_tpu_torch.ops import band2
from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
from owl_audio_exps_tpu_torch.utils.weights import params_from_jax

from torch_port_util import (MODEL_RNGS, TINY_AV, carried, jax_apply, jax_core,
                             numpy_params, t)

# the AV token layout at a band2 geometry: 8 x 8 video + 1 audio token a
# frame (tpf 65), 32 frames, a 16-frame window: L = 2,080, plan (520, 2)
AV_BAND2 = dict(TINY_AV, n_layers=4, n_heads=1, d_model=64, sample_size=8,
                tokens_per_frame=65, n_frames=32, causal=True,
                local_window=16, cfg_prob=0.25)


def _av_batch(rs, b, cfg):
    n, p = cfg.n_frames, cfg.sample_size
    return (rs.randn(b, n, cfg.channels, p, p).astype(np.float32),
            rs.randn(b, n, cfg.audio_channels).astype(np.float32),
            rs.randn(b, n, 2).astype(np.float32),
            (rs.rand(b, n, cfg.n_buttons) > 0.5).astype(np.float32))


def _draws(out):
    return dict(ts=t(out["ts"]), z_video=t(out["z_video"]),
                z_audio=t(out["z_audio"]), has_controls=t(out["cfg_mask"]))


# ------------------------------------------------------------------ model

def test_av_loss_and_gradients_match_jax(monkeypatch):
    jcfg = jax_config(**AV_BAND2)
    pcfg = port_config(**AV_BAND2, attn_impl="splash")
    assert attention_route(pcfg, True, 32 * 65) == ("band2", (520, 2))
    batch = _av_batch(np.random.RandomState(0), 2, jcfg)
    model, params = jax_core(JaxGameRFTAudio, jcfg, *batch,
                             rngs=MODEL_RNGS)
    jin = [jnp.asarray(a) for a in batch]

    def loss_and_draw(p):
        out = model.apply(p, *jin, return_dict=True,
                          rngs={"noise": jax.random.key(5)})
        return out["diffusion_loss"], out

    (loss_j, out), grads_j = jax.jit(jax.value_and_grad(
        loss_and_draw, has_aux=True))(params)
    assert not bool(np.all(np.asarray(out["cfg_mask"])))  # cfg dropped

    calls = []
    orig = band2.band2_attention
    monkeypatch.setattr(band2, "band2_attention", lambda *a, **kw: (
        calls.append(a[5:7]), orig(*a, **kw))[1])
    port = carried(GameRFTAudio, pcfg, params)
    loss, v_loss, a_loss = port(*(t(a) for a in batch), **_draws(out))
    loss.backward()
    assert calls == [(520, 2)] * 3          # the 3 local layers
    for got, key in ((loss, "diffusion_loss"), (v_loss, "video_loss"),
                     (a_loss, "audio_loss")):
        np.testing.assert_allclose(got.item(), float(out[key]), rtol=1e-5,
                                   err_msg=key)
    want = params_from_jax(numpy_params(grads_j), jcfg.n_heads)
    assert set(want) == {n for n, _ in port.named_parameters()}
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("scan_layers", [False, True],
                         ids=["unrolled", "scanned"])
def test_params_from_jax_covers_every_key_of_the_av_wrapper(scan_layers):
    """Every key of the JAX GameRFTAudio tree (audio_proj_in and
    audio_proj_out included), unrolled or scan_layers-stacked, maps onto
    the port's wrapper, and the loaded wrapper gives the JAX loss."""
    kw = dict(TINY_AV, n_layers=8, causal=True, cfg_prob=0.0,
              scan_layers=scan_layers)
    jcfg, pcfg = jax_config(**kw), port_config(**kw)
    batch = _av_batch(np.random.RandomState(1), 1, jcfg)
    model, params = jax_core(JaxGameRFTAudio, jcfg, *batch,
                             rngs=MODEL_RNGS)
    sd = params_from_jax(numpy_params(params), jcfg.n_heads)
    port = GameRFTAudio(pcfg, dtype=torch.float32, device="cpu", seed=None)
    want = port.state_dict()
    assert set(sd) == set(want)
    assert {"core.audio_proj_in.weight", "core.audio_proj_out.proj.weight",
            "core.audio_proj_out.norm.fc.weight"} <= set(sd)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
    port.load_state_dict(sd, strict=True)
    out = jax_apply(model, params, *batch, return_dict=True,
                    rngs={"noise": jax.random.key(2)})
    with torch.no_grad():
        loss = port(*(t(a) for a in batch), **_draws(out))[0]
    np.testing.assert_allclose(loss.item(), float(out["diffusion_loss"]),
                               rtol=1e-5)


def test_av_remat_changes_neither_loss_nor_gradients():
    """Group remat (blocks and the edge projections, which then run again
    in the backward) gives the loss and gradients of no remat."""
    batch = [t(a) for a in _av_batch(np.random.RandomState(2), 1,
                                     port_config(**AV_BAND2))]
    results = {}
    for mode, extra in (("off", {}), ("group", dict(
            gradient_checkpointing=True, remat_granularity="group"))):
        cfg = port_config(**AV_BAND2, attn_impl="splash", **extra)
        model = GameRFTAudio(cfg, dtype=torch.float32, device="cpu", seed=0)
        # a pre-hook: the recompute stops once it has what the backward
        # saved, before a forward hook would run
        edge_calls = []
        for name in ("proj_in", "audio_proj_in", "proj_out",
                     "audio_proj_out"):
            getattr(model.core, name).register_forward_pre_hook(
                lambda *_, name=name: edge_calls.append(name))
        loss = model(*batch, generator=torch.Generator().manual_seed(3))[0]
        loss.backward()
        results[mode] = (loss.item(), {n: p.grad.clone() for n, p in
                                       model.named_parameters()})
        assert len(edge_calls) == (4 if mode == "off" else 8)
    ref_loss, ref = results["off"]
    loss, grads = results["group"]
    assert loss == pytest.approx(ref_loss, rel=1e-6, abs=0)
    for n in ref:
        torch.testing.assert_close(grads[n], ref[n], atol=1e-6, rtol=1e-5)


def test_av_registry_and_draws_from_the_generator():
    assert get_model_cls("game_rft_audio") is GameRFTAudio
    cfg = port_config(**dict(TINY_AV, causal=True, cfg_prob=0.5))
    m = GameRFTAudio(cfg, dtype=torch.float32, device="cpu")
    batch = [t(a) for a in _av_batch(np.random.RandomState(3), 4, cfg)]
    a = m(*batch, generator=torch.Generator().manual_seed(7))
    b = m(*batch, generator=torch.Generator().manual_seed(7))
    c = m(*batch, generator=torch.Generator().manual_seed(8))
    assert a[0].item() == b[0].item() != c[0].item()
    assert all(torch.isfinite(x) for x in a)
    torch.testing.assert_close(a[0], a[1] + a[2])


# --------------------------------------------------------------- trainers

def _train_dict(trainer_id, data_id, tmp_path):
    return {
        "model": dict(TINY_AV, causal=True, cfg_prob=0.25),
        "train": dict(
            trainer_id=trainer_id, data_id=data_id,
            data_kwargs=dict(window_length=8, channels=4, audio_channels=4,
                             sample_size=2, n_buttons=11),
            target_batch_size=2, batch_size=2, opt="AdamW",
            opt_kwargs=dict(lr=1e-3, eps=1e-2), vae_scale=0.87,
            audio_vae_scale=0.45, save_interval=1000, log_interval=1,
            checkpoint_dir=str(tmp_path / "ckpt")),
        "wandb": {"run_name": f"port_av_{trainer_id}"}}


@pytest.mark.parametrize("trainer_id,data_id", [
    ("av", "synthetic_av"), ("mixed_av", "synthetic_mixed")])
def test_av_trainer_step_matches_jax(trainer_id, data_id, tmp_path):
    """One optimizer step of the port's trainer (loss_fn with vae_scale and
    audio_vae_scale, clip, AdamW, EMA) against the JAX trainer's jitted
    step on the same synthetic batch, given the JAX step's noise draw:
    loss, metrics and updated parameters."""
    raw = _train_dict(trainer_id, data_id, tmp_path)
    jtr = jax_trainer_cls(trainer_id)(JaxConfig.from_dict(raw))
    jtr.model = JaxGameRFTAudio(jtr.model_cfg, dtype=jnp.float32)
    state = jtr.init_state()
    params0 = numpy_params(state.params)
    kw = raw["train"]["data_kwargs"]
    batch = next(iter(jax_loader(data_id, 2, **kw)))
    for a, b in zip(batch, next(iter(get_loader(data_id, 2, **kw)))):
        np.testing.assert_array_equal(a, b)    # the same stream
    rng = jax.random.key(11)
    step = jtr.make_train_step(jtr._wrapped_loss, 1,
                               clip_norm=jtr.grad_clip_norm())
    new_state, metrics_j = step(state, _stack_accum([batch]), rng)

    # the step's noise: its micro-batch key, on the loss_fn's inputs
    vid = (jnp.asarray(batch[0]) / 0.87).astype(jnp.bfloat16)
    audio = (jnp.asarray(batch[1]) / 0.45).astype(jnp.bfloat16)
    extra = ({} if trainer_id == "av" else
             {"has_controls": jnp.asarray(batch[4]).astype(bool)})
    out = jax_apply(jtr.model, {"params": params0}, vid, audio, batch[2],
                    batch[3], return_dict=True, **extra,
                    rngs={"noise": jax.random.split(rng, 1)[0]})

    ptr = get_trainer_cls(trainer_id)(Config.from_dict(raw), device="cpu")
    model = carried(GameRFTAudio, ptr.model_cfg, {"params": params0})
    pstate = ptr.make_state(model.train())
    draws, seen = _draws(out), []
    forward = model.forward

    def with_jax_draws(vid, audio, mouse, btn, has_controls=None,
                       generator=None):
        seen.append((vid, audio, has_controls))
        return forward(vid, audio, mouse, btn, **draws)

    model.forward = with_jax_draws
    metrics_p = ptr.train_step(pstate, [ptr.to_device(batch)],
                               torch.Generator(),
                               clip_norm=ptr.grad_clip_norm())
    (vid_p, audio_p, has_p), = seen
    np.testing.assert_array_equal(vid_p.float().numpy(),
                                  np.asarray(vid.astype(jnp.float32)))
    np.testing.assert_array_equal(audio_p.float().numpy(),
                                  np.asarray(audio.astype(jnp.float32)))
    if trainer_id == "mixed_av":
        np.testing.assert_array_equal(has_p.numpy(), batch[4])
    assert set(metrics_p) == set(metrics_j)
    for key, value in metrics_j.items():
        np.testing.assert_allclose(float(metrics_p[key]), float(value),
                                   rtol=1e-5, err_msg=key)
    want = params_from_jax(numpy_params(new_state.params),
                           jtr.model_cfg.n_heads)
    for name, p in pstate.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=name)
    ema = params_from_jax(numpy_params(new_state.ema_params),
                          jtr.model_cfg.n_heads)
    for name, e in pstate.ema.items():
        np.testing.assert_allclose(e.numpy(), ema[name].numpy(), atol=1e-6,
                                   rtol=1e-5, err_msg=name)


def test_av_entry_point_and_port_cuts(tmp_path):
    """The CLI trains the AV model on the CPU when asked, and the port cuts
    give each AV trainer a synthetic source with its batch columns."""
    import os
    import yaml
    from owl_audio_exps_tpu_torch.train import main, port_cuts
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name, trainer_id, data_id, synthetic in (
            ("av_v5_8x8_weak.yml", "av", "cod_s3_audio", "synthetic_av"),
            ("av_v5_mixed.yml", "mixed_av", "cod_s3_mixed",
             "synthetic_mixed")):
        cfg = Config.from_yaml(os.path.join(repo, "configs", name))
        assert (cfg.train.trainer_id, cfg.train.data_id) == (trainer_id,
                                                             data_id)
        sampler_id = cfg.train.sampler_id
        cuts = port_cuts(cfg, 1)
        # the eval loader is cut to the same source; the window samplers
        # the AV eval runs are kept
        assert [c.split()[0] for c in cuts] == ["data_id", "sample_data_id"]
        assert cfg.train.data_id == synthetic and synthetic in cuts[0]
        assert cfg.train.sample_data_id == synthetic and synthetic in cuts[1]
        assert cfg.train.sampler_id == sampler_id
        kw = dict(cfg.train.data_kwargs.items())
        assert kw == dict(window_length=16, channels=64, sample_size=8,
                          n_buttons=11, n_mouse_axes=2, audio_channels=64)
        assert dict(cfg.train.sample_data_kwargs.items()) == kw
        batch = next(iter(get_loader(cfg.train.data_id, 2, **kw)))
        assert len(batch) == (4 if trainer_id == "av" else 5)
        assert batch[1].shape == (2, 16, 64)

        raw = _train_dict(trainer_id, "cod_s3_audio" if trainer_id == "av"
                          else "cod_s3_mixed", tmp_path)
        raw["model"].update(gradient_checkpointing=True,
                            remat_granularity="group")
        raw["train"].update(opt="Muon", opt_kwargs=dict(
            lr=1e-3, adamw_lr=1e-4,
            adamw_keys=["core.proj_in", "core.proj_out.proj"]))
        path = tmp_path / f"{trainer_id}.yml"
        path.write_text(yaml.safe_dump(raw))
        main(["--config_path", str(path), "--max_steps", "1", "--device",
              "cpu"])
    # the audio VAE trainer and the MeanFlow model are ported
    assert get_trainer_cls("audio_vae").__name__ == "AudioVAETrainer"
    assert get_model_cls("game_mft_audio").__name__ == "GameMFTAudio"
