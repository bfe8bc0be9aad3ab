"""The port's warm-cache writer and offline sampling CLI
(owl_audio_exps_tpu_torch/inference/{build_cache,test_sampling}.py)
against the root JAX scripts inference/build_cache.py and
inference/test_sampling.py, on the CPU at tiny widths.

* build_cache: both scripts on one cod table (written with the port's
  NpyTable) write the same npz arrays, bit for bit, 3- and 4-column; the
  port's ``CausvidPipeline.load_cache`` reads them.
* test_sampling: on a tiny dit_v4_tpu_e2e.yml (``av_caching``) and a tiny
  configs/audio.yml (``audio_caching``) the port's latents match the JAX
  script's (its params from the same init, its draws from its key 1
  handed to the port as ``SamplerNoise``) within two bf16 steps (rtol and
  atol 2 ** -6): both samplers run in bf16, whose step is 2 ** -7 of a
  value's binade, over the frameworks' differently ordered bf16
  products. The port's CLI writes
  ``--out``. On an AV config the JAX script fails at its core's init
  (it has no AV branch), and the port's samples with the window sampler
  (the window and an audio context added); a video-signature sampler on
  an AV core fails in both (ROADMAP.md Queue 3, reference behaviour 16).
"""

import importlib.util
import os
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from owl_audio_exps_tpu_torch.configs import Config
from owl_audio_exps_tpu_torch.data.npy_table import NpyTable
from owl_audio_exps_tpu_torch.inference import build_cache, test_sampling
from owl_audio_exps_tpu_torch.sampling.common import SamplerNoise
from owl_audio_exps_tpu_torch.utils.weights import params_from_jax

from torch_port_util import jax_init, jax_sampler_draws, numpy_params, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_TWO_STEPS = 2.0 ** -6


def _root_script(name):
    spec = importlib.util.spec_from_file_location(
        f"root_{name}", os.path.join(REPO, "inference", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_root(name, monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", [name] + argv)
    _root_script(name).main()


def _yaml(tmp_path, name, raw):
    path = tmp_path / f"{name}.yml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


# ---------------------------------------------------------- build_cache

def _cod_table(path, audio: bool):
    rs = np.random.RandomState(0)
    cols = ["video", "mouse", "buttons"] + (["audio"] if audio else [])
    table = NpyTable(str(path), columns=cols + [
        "tarball", "pt_idx", "missing", "truncated", "seq_len"],
        array_columns=cols)
    for i, n in enumerate((9, 14)):
        row = dict(video=rs.randn(n, 4, 2, 2).astype(np.float16),
                   mouse=rs.randn(n, 2).astype(np.float32),
                   buttons=(rs.rand(n, 3) > 0.5).astype(np.float32))
        if audio:
            row["audio"] = rs.randn(n, 4).astype(np.float32)
        table.append(tarball=f"d{i}", pt_idx=i, missing=False,
                     truncated=False, seq_len=n, **row)


@pytest.mark.parametrize("audio", [False, True])
def test_build_cache_writes_the_jax_scripts_buffers(tmp_path, monkeypatch,
                                                    audio):
    _cod_table(tmp_path / "table", audio)
    order = ["video", "audio", "mouse", "buttons"] if audio else \
        ["video", "mouse", "buttons"]
    path = _yaml(tmp_path, "cfg", {
        "model": {"model_id": "game_rft_audio", "channels": 4,
                  "sample_size": 2, "audio_channels": 4, "n_buttons": 3},
        "train": {"data_id": "cod", "data_kwargs": {
            "dataset_path": str(tmp_path / "table"), "window_length": 4,
            "batch_columns": order}}})
    _run_root("build_cache", monkeypatch, [
        "--config_path", path, "--out_dir", str(tmp_path / "jax"),
        "--n_samples", "5"])
    build_cache.main(["--config_path", path, "--out_dir",
                      str(tmp_path / "port"), "--n_samples", "5"])
    for i in range(5):
        want = np.load(tmp_path / "jax" / f"buffers_{i}.npz")
        got = np.load(tmp_path / "port" / f"buffers_{i}.npz")
        assert set(got.files) == set(want.files) == {
            "history", "audio", "mouse", "button"}
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["audio"].shape == (1, 4, 4) and (audio or
                                                not got["audio"].any())

    # the window pipeline warm-starts from them
    from owl_audio_exps_tpu_torch.configs import transformer_config
    from owl_audio_exps_tpu_torch.inference.pipeline import CausvidPipeline
    from owl_audio_exps_tpu_torch.models.gamerft_audio import \
        GameRFTAudioCore
    cfg = transformer_config(
        model_id="game_rft_audio", n_layers=2, n_heads=2, d_model=32,
        channels=4, audio_channels=4, sample_size=2, tokens_per_frame=5,
        n_frames=8, n_buttons=3, causal=True, uncond=False, has_audio=True,
        rope_impl="ortho", local_window=2, global_window=None, cfg_prob=0.0)
    core = GameRFTAudioCore(cfg, dtype=torch.float32, device="cpu", seed=0)
    pipe = CausvidPipeline(core, cfg, window_length=4, sampling_steps=1,
                           device="cpu", image_scale=2.0)
    pipe.load_cache(str(tmp_path / "port"), cache_idx=3)
    data = np.load(tmp_path / "port" / "buffers_3.npz")
    assert torch.equal(pipe.buffers.history, torch.from_numpy(
        data["history"] / 2.0).to(torch.bfloat16))
    assert torch.equal(pipe.buffers.button, torch.from_numpy(
        data["button"]).to(torch.bfloat16))


# --------------------------------------------------------- test_sampling

TINY = dict(n_layers=2, n_heads=2, d_model=32)


def _tiny(name, **model):
    raw = Config.from_yaml(os.path.join(REPO, "configs", name)).to_dict()
    raw["model"].update(TINY, **model)
    return raw


def _jax_params(raw, ctx_frames):
    """The JAX script's params: its core's init from key 0 on the seeded
    context (jitted, as the script's eager init draws them), carried into
    the port's layout."""
    from owl_audio_exps_tpu.configs import Config as JaxConfig
    from owl_audio_exps_tpu.models import get_core_cls
    m = JaxConfig.from_dict(raw).model
    core = get_core_cls(m.model_id)(m)
    rs = np.random.RandomState(0)
    bf = jax.numpy.bfloat16
    if m.model_id == "audio_rft":
        ctx = jax.numpy.asarray(rs.randn(1, 16, m.channels), bf)
        _, params = jax_init(core, ctx, jax.numpy.zeros((1, 16), bf))
    else:
        total = ctx_frames
        ctx = jax.numpy.asarray(rs.randn(1, 8, m.channels, m.sample_size,
                                         m.sample_size), bf)
        mouse = jax.numpy.asarray(rs.randn(1, total, 2), bf)
        btn = jax.numpy.asarray(rs.rand(1, total, m.n_buttons) > 0.5, bf)
        _, params = jax_init(core, ctx, jax.numpy.zeros((1, 8), bf),
                             mouse[:, :8], btn[:, :8])
    return params_from_jax(numpy_params(params["params"]), m.n_heads)


@pytest.mark.parametrize("name,num", [("dit_v4_tpu_e2e.yml", 3),
                                      ("audio.yml", 3)])
def test_sampling_cli_matches_the_jax_script(tmp_path, monkeypatch, name,
                                             num):
    over = dict(n_frames=16) if name.startswith("dit") else {}
    raw = _tiny(name, **over)
    if name == "audio.yml":
        raw["train"]["sampler_kwargs"]["num_tokens"] = num
    path = _yaml(tmp_path, "cfg", raw)
    _run_root("test_sampling", monkeypatch, [
        "--config_path", path, "--num_frames", str(num), "--out",
        str(tmp_path / "jax.npy")])
    want = np.load(tmp_path / "jax.npy")

    cfg = Config.from_dict(raw)
    m = cfg.model
    if m.model_id == "audio_rft":
        ctx, init, ren = jax_sampler_draws(jax.random.key(1),
                                           (1, 16, m.channels),
                                           (m.channels,), num)
    else:
        item = (m.channels, m.sample_size, m.sample_size)
        ctx, init, ren = jax_sampler_draws(jax.random.key(1),
                                           (1, 8) + item, item, num)
    noise = SamplerNoise(t(ctx), t(init), t(ren))
    got, audio, _ = test_sampling.sample(
        cfg, _jax_params(raw, 8 + num), num, device="cpu", noise=noise)
    assert audio is None and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want,
                               rtol=BF16_TWO_STEPS, atol=BF16_TWO_STEPS)

    # the CLI itself, seeded weights, --out written
    out = tmp_path / "port.npy"
    test_sampling.main(["--config_path", path, "--num_frames", str(num),
                        "--device", "cpu", "--out", str(out)])
    lat = np.load(out)
    assert lat.shape == want.shape and np.isfinite(lat).all()


def test_sampling_cli_on_an_av_config(tmp_path, monkeypatch, capsys):
    """configs/av_v4_8x8.yml (``av_window``): the JAX script has no AV
    branch and fails at its core's init; the port's draws the window's
    context and an audio context and samples, the context frames coming
    back as given. A video-signature sampler (``av_caching``) on the AV
    core fails in both."""
    raw = _tiny("av_v4_8x8.yml", n_frames=16)
    raw["train"]["sampler_kwargs"].update(n_steps=2, window_length=4)
    path = _yaml(tmp_path, "av", raw)
    with pytest.raises(IndexError):
        _run_root("test_sampling", monkeypatch, [
            "--config_path", path, "--num_frames", "2"])
    lat = test_sampling.main(["--config_path", path, "--num_frames", "2",
                              "--device", "cpu"])
    assert tuple(lat.shape) == (1, 8 + 2, 128, 8, 8)
    rs = np.random.RandomState(0)
    ctx = torch.from_numpy(rs.randn(1, 8, 128, 8, 8).astype(np.float32))
    assert torch.equal(lat[:, :8], ctx.to(torch.bfloat16))
    assert "audio (1, 10, 64)" in capsys.readouterr().out

    raw["train"]["sampler_id"] = "av_caching"
    path = _yaml(tmp_path, "av_caching", raw)
    with pytest.raises(IndexError):
        _run_root("test_sampling", monkeypatch, [
            "--config_path", path, "--num_frames", "2"])
    with pytest.raises(TypeError, match="audio stream"):
        test_sampling.main(["--config_path", path, "--num_frames", "2",
                            "--device", "cpu"])
