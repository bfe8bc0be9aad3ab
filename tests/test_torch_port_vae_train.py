"""The port's audio VAE trainer, waveform loader, media export and the
trainers' VAE paths against the JAX package on the CPU: ``stft_mag`` and
``multires_stft_loss``, one ``AudioVAETrainer`` step against the JAX
trainer's jitted step, ``local_waveform`` windows, the ``audio_vae`` CLI,
``AudioRFTTrainer`` encoding through a saved encoder and its eval WAV,
the AV trainer's eval export, and the media writers.

Tolerances, each stated where it is used: float32 losses rtol 1e-5 (the
FFTs and reductions of two libraries), their gradients relative L2 5e-3;
a step's parameters atol 1e-6 (1% of the learning rate 1e-4) + rtol
1e-5; the bridge's bf16 encoders
and decoders relative L2 2e-2 (a few bf16 roundings through the stack);
file writers byte for byte."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_audio_exps_tpu.configs import Config as JaxConfig
from owl_audio_exps_tpu.data import local_waveform as jax_waveform
from owl_audio_exps_tpu.nn.audio_vae import AudioDecoder as JaxAudioDecoder
from owl_audio_exps_tpu.nn.audio_vae import AudioEncoder as JaxAudioEncoder
from owl_audio_exps_tpu.nn.audio_vae import AudioVAE as JaxAudioVAE
from owl_audio_exps_tpu.trainers import get_trainer_cls as jax_trainer_cls
from owl_audio_exps_tpu.trainers import audio_vae_trainer as jax_vae_trainer
from owl_audio_exps_tpu.utils import media as jax_media
from owl_audio_exps_tpu.utils import owl_vae_bridge as jax_bridge
from owl_audio_exps_tpu_torch.configs import Config
from owl_audio_exps_tpu_torch.data import get_loader
from owl_audio_exps_tpu_torch.data import local_waveform
from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
from owl_audio_exps_tpu_torch.trainers.audio_vae_trainer import (
    AudioVAETrainer, multires_stft_loss, stft_mag)
from owl_audio_exps_tpu_torch.utils import media
from owl_audio_exps_tpu_torch.utils.weights import vae_params_from_jax

from torch_port_util import batch, jax_init, numpy_params, t

T = 735 * 4
BF16_REL_L2 = 2e-2


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def write_tones(root, lengths, seed=0):
    """Seeded stereo tones with noise, one ``<i>_wf.pt`` [n, 2] file per
    length, as the waveform loader reads them."""
    os.makedirs(root, exist_ok=True)
    rs = np.random.RandomState(seed)
    for i, n in enumerate(lengths):
        t = np.arange(n) / 44100.0
        f = rs.uniform(100, 2000, size=2)
        wf = 0.5 * np.sin(2 * np.pi * f[None] * t[:, None]) \
            + 0.05 * rs.randn(n, 2)
        torch.save(torch.from_numpy(wf.astype(np.float32)),
                   os.path.join(root, f"{i}_wf.pt"))
    return str(root)


# ------------------------------------------------------------------ STFT
def test_stft_mag_matches_jax():
    """Symmetric Hann window (jnp.hanning), frames every hop, rFFT
    magnitudes; float32, rtol 1e-5 / atol 1e-4 (magnitudes reach ~1e2)."""
    x = np.random.RandomState(0).randn(2, 4096).astype(np.float32)
    for frame, hop in ((512, 128), (1024, 256), (2048, 512)):
        got = stft_mag(torch.from_numpy(x), frame, hop)
        want = np.asarray(jax_vae_trainer.stft_mag(jnp.asarray(x), frame,
                                                   hop))
        assert tuple(got.shape) == want.shape == (
            2, 1 + (4096 - frame) // hop, frame // 2 + 1)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        torch.hann_window(512, periodic=False).numpy(), np.hanning(512),
        atol=1e-7)


@pytest.mark.parametrize("case", ["identical", "offset", "random"])
def test_multires_stft_loss_matches_jax(case):
    """One Frobenius norm over the whole [b, frames, bins] tensor for the
    spectral convergence; float32, rtol 1e-5."""
    rs = np.random.RandomState(1)
    target = rs.randn(2, 4096, 2).astype(np.float32)
    pred = {"identical": target, "offset": target + 0.5,
            "random": rs.randn(2, 4096, 2).astype(np.float32)}[case]
    got = float(multires_stft_loss(torch.from_numpy(pred),
                                   torch.from_numpy(target)))
    want = float(jax_vae_trainer.multires_stft_loss(jnp.asarray(pred),
                                                    jnp.asarray(target)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert (got < 1e-5) == (case == "identical")
    if case == "random":
        # d/dsp log(sp + 1e-5) amplifies float32 FFT rounding where a
        # magnitude is small: the packages' gradients differ by ~1e-3
        # relative L2 (JAX's is the farther from a float64 evaluation)
        pred_t = torch.from_numpy(pred).requires_grad_()
        multires_stft_loss(pred_t, torch.from_numpy(target)).backward()
        want_g = jax.grad(jax_vae_trainer.multires_stft_loss)(
            jnp.asarray(pred), jnp.asarray(target))
        assert rel_l2(pred_t.grad, want_g) <= 5e-3


# ---------------------------------------------------------------- loader
def test_local_waveform_windows_match_jax(tmp_path):
    """The same files, windows and padding in both packages: file and
    start drawn from RandomState(1234 + process_index), a file shorter
    than the window zero-padded; and the registry serves it."""
    root = write_tones(tmp_path / "wf", [5000, 1200, 9000])
    for process_index in (0, 1):
        want = iter(jax_waveform.get_loader(3, root, 2000,
                                            process_index=process_index))
        got = iter(local_waveform.get_loader(3, root, 2000,
                                             process_index=process_index))
        for _ in range(4):
            a, b = next(want), next(got)
            assert b.dtype == np.float32 and b.shape == (3, 2000, 2)
            np.testing.assert_array_equal(a, b)
    batch = next(iter(get_loader("local_waveform", 2, root_dir=root,
                                 window_length=735)))
    assert batch.shape == (2, 735, 2)
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="No \\*_wf.pt"):
        local_waveform.get_loader(1, str(tmp_path / "empty"), 10)


# --------------------------------------------------------------- trainer
def vae_cfg(tmp_path, root, **train):
    return {"model": {"model_id": "audio_vae", "channels": 64},
            "train": dict({"trainer_id": "audio_vae",
                           "data_id": "local_waveform",
                           "data_kwargs": {"window_length": T,
                                           "root_dir": root},
                           "batch_size": 2, "target_batch_size": 2,
                           "opt_kwargs": {"lr": 1e-4, "weight_decay": 1e-4},
                           "stft_weight": 1.0, "latent_weight": 1e-3,
                           "checkpoint_dir": str(tmp_path / "ckpt"),
                           "save_interval": 100, "sample_interval": 100},
                          **train),
            "wandb": {"run_name": "vae_test"}}


def test_audio_vae_trainer_step_matches_jax(tmp_path, monkeypatch):
    """One step of each package's trainer from the same float32 weights
    (the JAX trainer's key-0 init on its first batch, carried) on the same
    local_waveform batch: the metrics rtol 1e-5, the parameters and the
    EMA after the step atol 1e-6 (1% of lr) + rtol 1e-5.

    Both run AdamW with eps 1 in place of 1e-8. Adam's first step moves
    every parameter by lr x g / (|g| + eps): at eps 1e-8 that is lr x
    sign(g), so a gradient that sums to nearly zero, whose sign the two
    libraries' summation orders decide, moves by +lr in one and -lr in the
    other (27 of 196,608 weights of one layer). At eps 1 the step moves by
    at most lr x |g difference|, and the float32 STFT gradients of the two
    packages differ by up to ~0.6% relative L2 in a layer
    (test_multires_stft_loss_matches_jax)."""
    import functools
    import optax
    monkeypatch.setattr(jax_vae_trainer.optax, "adamw",
                        functools.partial(optax.adamw, eps=1.0))
    root = write_tones(tmp_path / "wf", [20000, 9000])
    raw = vae_cfg(tmp_path, root)
    jtr = jax_trainer_cls("audio_vae")(JaxConfig.from_dict(raw))
    jtr.vae = JaxAudioVAE(64, dtype=jnp.float32)
    jlogs = []
    jtr.logger.log = lambda log, step: jlogs.append(dict(log))
    wf0 = jnp.asarray(next(iter(jax_waveform.get_loader(2, root, T))),
                      jnp.bfloat16)
    # the trainer's init (key 0 on its first batch), jitted for time
    _, init = jax_init(jtr.vae, wf0)
    monkeypatch.setattr(JaxAudioVAE, "init", lambda self, rng, x: init)
    params0 = numpy_params(init)
    jstate = jtr.train(max_steps=1)

    ptr = AudioVAETrainer(Config.from_dict(raw), device="cpu",
                          dtype=torch.float32)
    plogs = []
    ptr.logger.log = lambda log, step: plogs.append(dict(log))
    init_state = ptr.init_state

    def carried_init(seed=0):
        state = init_state(seed)
        state.model.load_state_dict(vae_params_from_jax(params0),
                                    strict=True)
        state.ema = {n: p.detach().clone()
                     for n, p in state.model.named_parameters()}
        state.optimizer.param_groups[0]["eps"] = 1.0
        return state

    ptr.init_state = carried_init
    pstate = ptr.train(max_steps=1)
    assert pstate.step == int(jstate.step) == 1
    for key in ("loss", "l1", "stft", "latent_l2"):
        np.testing.assert_allclose(plogs[0][key], jlogs[0][key], rtol=1e-5,
                                   err_msg=key)
    for tree, got in ((jstate.params, dict(
            pstate.model.named_parameters())), (jstate.ema_params,
                                                pstate.ema)):
        want = vae_params_from_jax(numpy_params(tree))
        assert set(want) == set(got)
        for name, w in want.items():
            np.testing.assert_allclose(got[name].detach().numpy(),
                                       w.numpy(), atol=1e-6, rtol=1e-5,
                                       err_msg=name)


def test_audio_vae_cli_saves_and_is_registered(tmp_path, capsys):
    """configs/audio_vae.yml through the port's train.py (root_dir -> the
    test's tone files, the window cut to 4 latents for the CPU): no cut is
    printed, step 2 is saved, and params and EMA changed and are finite."""
    import yaml
    from owl_audio_exps_tpu_torch.train import main
    assert get_trainer_cls("audio_vae") is AudioVAETrainer
    with open("configs/audio_vae.yml") as f:
        raw = yaml.safe_load(f)
    raw["train"]["data_kwargs"].update(
        root_dir=write_tones(tmp_path / "wf", [12000]), window_length=T)
    raw["train"].update(batch_size=2, target_batch_size=2, save_interval=2,
                        checkpoint_dir=str(tmp_path / "ckpt"))
    path = tmp_path / "audio_vae.yml"
    path.write_text(yaml.safe_dump(raw))
    init = AudioVAETrainer(Config.from_dict(raw), device="cpu").init_state()
    main(["--config_path", str(path), "--max_steps", "2", "--device", "cpu"])
    assert "[train] cut" not in capsys.readouterr().out
    ckpt = torch.load(tmp_path / "ckpt" / "step_2.pt", weights_only=True)
    assert ckpt["step"] == 2
    for name, p0 in init.model.named_parameters():
        p, e = ckpt["params"][name], ckpt["ema_params"][name]
        assert torch.isfinite(p).all() and torch.isfinite(e).all()
        if name.endswith("weight") and p0.ndim == 3:
            assert not torch.equal(p, p0.detach()), name
            assert not torch.equal(e, p0.detach()), name


# ------------------------------------------------- the audio RFT trainer
AUDIO_MODEL = {"model_id": "audio_rft", "sample_size": 8, "channels": 64,
               "n_layers": 2, "n_heads": 2, "d_model": 32,
               "tokens_per_frame": 1, "n_frames": 16, "cfg_prob": 0.0,
               "causal": True, "uncond": True, "backbone": "dit",
               "has_audio": True, "rope_impl": "audio1d", "local_window": 4,
               "global_window": None}


def jax_bridge_params(latent_channels):
    """The JAX bridge's audio encoder and decoder params (key 0 on its
    example inputs, as get_audio_encoder_decoder draws them)."""
    _, enc = jax_init(JaxAudioEncoder(latent_channels=latent_channels),
                      jnp.zeros((1, 735 * 4, 2), jnp.bfloat16))
    _, dec = jax_init(JaxAudioDecoder(),
                      jnp.zeros((1, 4, latent_channels), jnp.bfloat16))
    return numpy_params(enc), numpy_params(dec)


@pytest.fixture
def jitted_jax_bridge_inits(monkeypatch):
    """The JAX bridge draws its modules' key-0 inits eagerly when it is
    given no checkpoint (several seconds each on the CPU); jitted, the
    draws are the same."""
    monkeypatch.setattr(
        jax_bridge, "_init_or_load",
        lambda module, example, ckpt_path: jax_init(module, example)[1])


def test_audio_rft_encodes_through_a_saved_encoder(tmp_path,
                                                   jitted_jax_bridge_inits):
    """vae_ckpt_path: the port reads <path>_enc / <path>_dec (here the JAX
    bridge's key-0 weights, saved as torch state_dicts; the JAX trainer
    draws the same with vae_cfg_path): waveforms are encoded and divided
    by vae_scale (bf16, relative L2 2e-2 against JAX), a step trains on
    them, and the eval writes the decoded first sample as a WAV equal to
    the JAX trainer's from the same latents (int16 samples, relative L2
    2e-2)."""
    from scipy.io import wavfile
    enc, dec = jax_bridge_params(64)
    torch.save(vae_params_from_jax(enc), tmp_path / "vae_enc")
    torch.save(vae_params_from_jax(dec), tmp_path / "vae_dec")
    train = {"trainer_id": "audio_rft", "data_id": "synthetic_waveform",
             "data_kwargs": {"n_samples": 735 * 8, "window_length": 735 * 8},
             "target_batch_size": 2,
             "batch_size": 2, "opt": "AdamW", "opt_kwargs": {"lr": 1e-3},
             "checkpoint_dir": str(tmp_path / "ckpt"), "save_interval": 100,
             "sample_interval": 1000, "vae_scale": 0.5, "n_samples": 1,
             "vae_batch_size": 2}
    jraw = {"model": AUDIO_MODEL, "train": dict(
        train, vae_cfg_path="in_repo",
        eval_media_dir=str(tmp_path / "jax"))}
    praw = {"model": AUDIO_MODEL, "train": dict(
        train, vae_ckpt_path=str(tmp_path / "vae"),
        eval_media_dir=str(tmp_path / "port"))}
    jtr = jax_trainer_cls("audio_rft")(JaxConfig.from_dict(jraw))
    ptr = get_trainer_cls("audio_rft")(Config.from_dict(praw), device="cpu")
    wf = (np.random.RandomState(3).randn(2, 735 * 8, 2) * 0.3
          ).astype(np.float32)
    got = ptr.to_latents(torch.from_numpy(wf))
    want = np.asarray(jtr._to_latents(jnp.asarray(wf)), np.float32)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 8, 64)
    assert rel_l2(got.float(), want) <= BF16_REL_L2
    torch.testing.assert_close(got, ptr.encode_fn(torch.from_numpy(wf))
                               / 0.5, rtol=0, atol=0)
    assert ptr.train(max_steps=1).step == 1

    lat = np.random.RandomState(4).randn(1, 8, 64).astype(np.float32)
    ptr.total_step_counter = jtr.total_step_counter = 5
    pout = ptr.eval_step(ptr.init_state(), None,
                         lambda core, ctx, generator: torch.from_numpy(lat))
    jout = jtr.eval_step(jtr.init_state(), None,
                         lambda core, params, ctx, key: jnp.asarray(lat))
    np.testing.assert_allclose(pout["eval/audio_latent_std"],
                               jout["eval/audio_latent_std"], rtol=1e-6)
    (prate, pwav), (jrate, jwav) = (
        wavfile.read(tmp_path / d / "audio_5.wav") for d in ("port", "jax"))
    assert prate == jrate == 44100 and pwav.dtype == np.int16
    assert pwav.shape == jwav.shape == (8 * 735, 2)
    assert rel_l2(pwav, jwav) <= BF16_REL_L2


# ------------------------------------------------------ the AV eval export
AV_MODEL = {"model_id": "game_rft_audio", "n_layers": 2, "n_heads": 2,
            "d_model": 32, "channels": 4, "audio_channels": 4,
            "sample_size": 2, "tokens_per_frame": 5, "n_frames": 8,
            "n_buttons": 11, "causal": True, "has_audio": True,
            "local_window": 2}


def test_av_export_writes_the_jax_files(tmp_path, jitted_jax_bridge_inits):
    """``_export_media`` on the same latents (the audio one frame longer:
    both crop to the common trailing window) and the same decoder weights
    (the JAX bridge's key-0 pixel-shuffle and audio decoders, carried):
    the same files, the decoded frames and waveform within the bf16
    relative L2 2e-2, the controls as given."""
    from owl_audio_exps_tpu.utils.owl_vae_bridge import (
        make_batched_audio_decode_fn, make_batched_decode_fn)
    train = {"trainer_id": "av", "vae_scale": 0.5, "audio_vae_scale": 2.0,
             "vae_batch_size": 2}
    jtr = jax_trainer_cls("av")(JaxConfig.from_dict({
        "model": AV_MODEL, "train": dict(
            train, eval_media_dir=str(tmp_path / "jax"))}))
    ptr = get_trainer_cls("av")(Config.from_dict({
        "model": AV_MODEL, "train": dict(
            train, eval_media_dir=str(tmp_path / "port"))}), device="cpu")
    jvdec = jax_bridge.PixelShuffleVideoDecoder(latent_channels=4)
    _, jdec = jax_bridge_params(4)
    vdec, adec = ptr.media_decoders()
    vdec.load_state_dict(vae_params_from_jax(numpy_params(jvdec.params)),
                         strict=True)
    adec.module.load_state_dict(vae_params_from_jax(jdec), strict=True)

    rs = np.random.RandomState(5)
    xl = rs.randn(1, 5, 4, 2, 2).astype(np.float32)
    al = rs.randn(1, 6, 4).astype(np.float32)
    mouse = rs.randn(1, 5, 2).astype(np.float32)
    btn = (rs.rand(1, 5, 11) > 0.5).astype(np.float32)
    ptr.total_step_counter = jtr.total_step_counter = 3
    jtr._export_media(jnp.asarray(xl, jnp.bfloat16),
                      jnp.asarray(al, jnp.bfloat16), jnp.asarray(mouse),
                      jnp.asarray(btn))
    ptr._export_media(torch.from_numpy(xl).to(torch.bfloat16),
                      torch.from_numpy(al).to(torch.bfloat16),
                      torch.from_numpy(mouse), torch.from_numpy(btn))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert {"step_3.gif", "step_3.wav"} <= set(names) and len(names) == 3

    frames, wf, m, b = ptr.decode_media(
        torch.from_numpy(xl).to(torch.bfloat16),
        torch.from_numpy(al).to(torch.bfloat16), torch.from_numpy(mouse),
        torch.from_numpy(btn))
    jv = make_batched_decode_fn(jvdec, 2)(
        jnp.asarray(xl, jnp.bfloat16) * 0.5)[0]
    adec_j = jax.jit(lambda z: JaxAudioDecoder().apply(jdec, z))
    ja = make_batched_audio_decode_fn(adec_j, 2)(
        jnp.asarray(al[:, -5:], jnp.bfloat16) * 2.0)[0]
    assert frames.shape == (5, 16, 16, 3) and wf.shape == (5 * 735, 2)
    assert rel_l2(frames, jv) <= BF16_REL_L2
    assert rel_l2(wf, ja) <= BF16_REL_L2
    np.testing.assert_array_equal(m, mouse[0])
    np.testing.assert_array_equal(b, btn[0])


# ----------------------------------------------------------------- media
@pytest.mark.parametrize("writer", ["gif", "wav", "avi", "bundle"])
def test_media_writers_match_jax(writer, tmp_path):
    """The port's copies of the JAX package's writers give the same bytes
    (``bundle``: every file of save_av_bundle, controls drawn)."""
    rs = np.random.RandomState(6)
    video = rs.uniform(-1, 1, (4, 32, 48, 3)).astype(np.float32)
    frames = media.to_uint8_frames(video)
    np.testing.assert_array_equal(frames, jax_media.to_uint8_frames(video))
    wf = rs.uniform(-1.2, 1.2, (4 * 735, 2)).astype(np.float32)
    mouse, buttons = rs.randn(4, 2), rs.rand(4, 11) > 0.5
    outs = []
    for mod in (jax_media, media):
        d = tmp_path / mod.__name__
        d.mkdir()
        if writer == "gif":
            mod.write_gif(str(d / "a.gif"), frames)
        elif writer == "wav":
            mod.write_wav(str(d / "a.wav"), wf)
        elif writer == "avi":
            mod.write_avi(str(d / "a.avi"), frames, wf)
        else:
            mod.save_av_bundle(str(d), "clip", video, wf, mouse, buttons)
        outs.append({f: (d / f).read_bytes() for f in sorted(os.listdir(d))})
    assert outs[0] == outs[1] and outs[1]
