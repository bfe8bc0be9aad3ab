"""The trainers' eval sampling in the port (trainers/rft_trainer.py
``RFTTrainer.eval_step``, ``AVRFTTrainer.eval_step``) and the port cuts
of the eval loader (train.py ``port_cuts``), on the CPU.

``RFTTrainer.eval_step`` is held against the JAX trainer's on the same EMA
weights, eval batch (the synthetic loaders draw the same numbers in both
packages) and sampler draws (the JAX eval's key 0, handed to the port's
sampler): the eval samples the EMA core with the cached video sampler on
the first half of the clip in bfloat16 latents (the eval casts them), so
the two sides round at the same points; ``eval/latent_std`` (which the JAX
eval takes in bfloat16) and the saved samples within 1 bfloat16 rounding
step (rtol 2^-7), the samples plus atol 1e-2. The CLI runs the eval through
``python -m owl_audio_exps_tpu_torch.train``.
"""

import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from owl_audio_exps_tpu.configs import Config as JaxConfig
from owl_audio_exps_tpu.data.synthetic import get_loader as jax_loader
from owl_audio_exps_tpu.trainers.rft_trainer import (
    RFTTrainer as JaxRFTTrainer)
from owl_audio_exps_tpu_torch.configs import Config
from owl_audio_exps_tpu_torch.data import get_loader
from owl_audio_exps_tpu_torch.models.gamerft import GameRFT, GameRFTCore
from owl_audio_exps_tpu_torch.sampling import get_sampler_cls
from owl_audio_exps_tpu_torch.sampling.common import SamplerNoise
from owl_audio_exps_tpu_torch.trainers import get_trainer_cls

from torch_port_util import (AV, VIDEO, carried, jax_sampler_draws, t,
                             video_cores)

VIDEO_KW = dict(window_length=6, channels=4, sample_size=2, n_buttons=3)


def _rft_dict(tmp_path, **train):
    return {
        "model": dict(VIDEO),
        "train": dict(dict(
            trainer_id="rft", data_id="synthetic_latent",
            data_kwargs=dict(VIDEO_KW, window_length=4),
            sample_data_id="synthetic_latent", sample_data_kwargs=VIDEO_KW,
            target_batch_size=1, batch_size=1, opt="AdamW",
            opt_kwargs=dict(lr=1e-3), scheduler=None, save_interval=1000,
            sample_interval=1, log_interval=1, n_samples=2,
            sampler_id="av_caching",
            sampler_kwargs=dict(n_steps=2, cfg_scale=1.0, num_frames=900,
                                noise_prev=0.2),
            checkpoint_dir=str(tmp_path / "ckpt"), output_path=None,
            vae_scale=0.5), **train),
        "wandb": {"run_name": "test"}}


def test_rft_eval_step_matches_jax(tmp_path):
    """The JAX trainer's ``eval_step`` code, run on a stand-in for its
    trainer (its config, its float32 core, one process), against the
    port's ``RFTTrainer.eval_step``."""
    raw = _rft_dict(tmp_path, eval_sample_dir=str(tmp_path / "jax"))
    jcfg = JaxConfig.from_dict(raw)
    _, _, jcore, params, _ = video_cores()
    jax_self = SimpleNamespace(
        train_cfg=jcfg.train, core=jcore, is_main=True,
        total_step_counter=0, broadcast_eval_batch=lambda batch: batch)
    jstate = SimpleNamespace(ema_params={"core": params["params"]})
    want = JaxRFTTrainer.eval_step(
        jax_self, jstate, iter(jax_loader("synthetic_latent", 2, **VIDEO_KW)),
        jax_trainer_sampler(raw))

    raw["train"]["eval_sample_dir"] = str(tmp_path / "port")
    ptr = get_trainer_cls("rft")(Config.from_dict(raw), device="cpu")
    model = carried(GameRFT, ptr.model_cfg,
                    {"params": {"core": params["params"]}})
    pstate = ptr.make_state(model)
    # the eval core in float32, as the JAX one here
    ptr._eval_core = GameRFTCore(ptr.model_cfg, dtype=torch.float32,
                                 device="cpu", seed=None)
    sampler = get_sampler_cls("av_caching")(**raw["train"]["sampler_kwargs"])
    ctx, init, renoise = jax_sampler_draws(jax.random.key(0), (2, 3, 4, 2, 2),
                                           (4, 2, 2), 3)
    noise = SamplerNoise(t(ctx), t(init), t(renoise))
    calls = []

    def with_jax_draws(core, x, mouse, btn, generator=None):
        calls.append(tuple(x.shape))
        assert core is ptr._eval_core and x.dtype == torch.bfloat16
        return sampler(core, x, mouse, btn, noise=noise)

    got = ptr.eval_step(pstate, iter(get_loader("synthetic_latent", 2,
                                                **VIDEO_KW)), with_jax_draws)
    assert calls == [(2, 3, 4, 2, 2)] and set(got) == {"eval/latent_std"}
    # the JAX std is taken over the bfloat16 latents in bfloat16
    np.testing.assert_allclose(got["eval/latent_std"],
                               want["eval/latent_std"], rtol=2.0 ** -7)
    jax_npy = np.load(tmp_path / "jax" / "samples_0.npy")
    port_npy = np.load(tmp_path / "port" / "samples_0.npy")
    assert port_npy.shape == jax_npy.shape == (2, 6, 4, 2, 2)
    np.testing.assert_allclose(port_npy, jax_npy, rtol=2.0 ** -7, atol=1e-2)
    assert ptr.eval_step(pstate, None, sampler) == {}


def jax_trainer_sampler(raw):
    from owl_audio_exps_tpu.sampling import get_sampler_cls as jax_cls
    return jax_cls(raw["train"]["sampler_id"])(
        **raw["train"]["sampler_kwargs"])


def test_rft_eval_through_the_cli(tmp_path, capsys):
    """One step of ``python -m owl_audio_exps_tpu_torch.train`` with
    sample_interval 1: the eval loader ``cod`` is cut to the synthetic
    source (printed), the cached sampler samples and the std is logged."""
    import yaml
    from owl_audio_exps_tpu_torch.train import main
    raw = _rft_dict(tmp_path, sample_data_id="cod",
                    sample_data_kwargs=dict(window_length=6,
                                            dataset_path="/nonexistent"),
                    eval_sample_dir=str(tmp_path / "samples"))
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(raw))
    main(["--config_path", str(path), "--max_steps", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] cut: sample_data_id 'cod' -> 'synthetic_latent'" in out
    assert "sampler_id" not in out
    line, = [ln for ln in out.splitlines() if ln.startswith("[step 1]")]
    std = float(line.split("eval/latent_std=")[1].split()[0])
    assert np.isfinite(std) and std > 0
    samples = np.load(tmp_path / "samples" / "samples_1.npy")
    assert samples.shape == (2, 6, 4, 2, 2) and np.isfinite(samples).all()


@pytest.mark.parametrize("trainer_id,data_id", [
    ("av", "synthetic_av"), ("mixed_av", "synthetic_mixed")])
def test_av_eval_step_returns_both_stds(tmp_path, trainer_id, data_id):
    kw = dict(VIDEO_KW, window_length=4, audio_channels=4)
    raw = {"model": dict(AV),
           "train": dict(trainer_id=trainer_id, data_id=data_id,
                         data_kwargs=kw, sample_data_id=data_id,
                         sample_data_kwargs=kw, target_batch_size=1,
                         batch_size=1, opt="AdamW", opt_kwargs=dict(lr=1e-3),
                         sampler_id="av_causal", n_samples=1,
                         sampler_kwargs=dict(n_steps=2, cfg_scale=1.3,
                                             window_length=4, num_frames=2),
                         checkpoint_dir=str(tmp_path), vae_scale=0.5)}
    tr = get_trainer_cls(trainer_id)(Config.from_dict(raw), device="cpu")
    state = tr.init_state()
    sampler = get_sampler_cls("av_causal")(**raw["train"]["sampler_kwargs"])
    loader = get_loader(data_id, 1, **kw)
    out = tr.eval_step(state, iter(loader), sampler)
    assert set(out) == {"eval/video_latent_std", "eval/audio_latent_std"}
    assert all(np.isfinite(v) and v > 0 for v in out.values())
    again = tr.eval_step(state, iter(loader), sampler)
    assert again == out     # the eval draws from a fixed seed
    assert tr.eval_step(state, None, sampler) == {}
    # with eval_media_dir the eval decodes its first clip through the VAE
    # bridge (vae_id null: the pixel-shuffle decoder) and writes it
    tr.train_cfg.eval_media_dir = str(tmp_path / "media")
    tr.total_step_counter = 7
    assert tr.eval_step(state, iter(loader), sampler) == out
    names = sorted(os.listdir(tmp_path / "media"))
    assert {"step_7.gif", "step_7.wav"} <= set(names) and len(names) == 3
