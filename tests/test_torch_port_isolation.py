"""The port stands alone: it imports torch, numpy and the standard library,
never JAX, flax or the JAX package, and it runs on the card unless the
caller asks for the CPU."""

import ast
import glob
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "owl_audio_exps_tpu_torch", "**", "*.py"),
              recursive=True)) + ["chip_smoke.py", "sp_smoke.py",
                                  "mesh_smoke.py", "bench_torch.py",
                                  "kernel_ab.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "owl_audio_exps_tpu")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_file_imports_no_jax(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = [m for m in _imported_modules(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_port_package_has_its_kernel_source():
    for src in ("frame_attention.cu", "band_attention.cu",
                "hopper_attention.cuh", "owl_loader.cpp"):
        assert os.path.exists(os.path.join(
            REPO, "owl_audio_exps_tpu_torch", "csrc", src)), src
    for module in ("ops/band.py", "ops/band2.py", "models/gamerft.py",
                   "models/gamerft_audio.py", "muon.py",
                   "trainers/rft_trainer.py", "train.py", "ops/local.py",
                   "parallel/dist.py", "parallel/mesh.py",
                   "parallel/context.py", "parallel/sharding.py", "nn/kv_cache.py", "nn/wquant.py",
                   "models/audiorft.py", "sampling/audio_caching.py",
                   "sampling/av_caching.py", "sampling/av_window.py",
                   "inference/pipeline.py", "trainers/distill_common.py",
                   "trainers/causvid.py", "trainers/self_forcing.py",
                   "trainers/ode_distill.py", "nn/audio_vae.py", "nn/dcae.py",
                   "utils/owl_vae_bridge.py", "utils/media.py",
                   "utils/vis.py", "data/local_waveform.py",
                   "trainers/audio_vae_trainer.py",
                   "inference/game_cv.py", "data/npy_table.py",
                   "data/native_loader.py", "data/cod_latent.py",
                   "data/latent_seq_packing.py", "data/prefetch.py",
                   "data/s3_cod_latent.py", "data/s3_cod_latent_mixed.py",
                   "models/gamemft_audio.py", "utils/profiling.py",
                   "inference/build_cache.py",
                   "inference/test_sampling.py"):
        assert os.path.join("owl_audio_exps_tpu_torch", module) in PORT_FILES
    assert len(PORT_FILES) > 30


def _run(code, cwd=REPO):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_port_runs_without_importing_jax():
    code = """
import sys, numpy as np, torch
from owl_audio_exps_tpu_torch.configs import transformer_config
from owl_audio_exps_tpu_torch.models.gamerft_audio import GameRFTAudioCore
from owl_audio_exps_tpu_torch.inference.pipeline import CausvidPipeline
import owl_audio_exps_tpu_torch.sampling.av_window
cfg = transformer_config(model_id="game_rft_audio", n_layers=2, n_heads=2,
    d_model=32, channels=4, audio_channels=4, sample_size=2,
    tokens_per_frame=5, n_frames=8, n_buttons=3, causal=True,
    has_audio=True, local_window=2)
core = GameRFTAudioCore(cfg, dtype=torch.float32, device="cpu")
pipe = CausvidPipeline(core, cfg, window_length=3, device="cpu")
frame, audio, _ = pipe(np.zeros(2), np.zeros(3))
assert torch.isfinite(frame.float()).all()
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "owl_audio_exps_tpu")]
print("FORBIDDEN", bad)
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "FORBIDDEN []" in res.stdout


def test_audio_serve_runs_without_importing_jax():
    code = """
import sys, torch
from owl_audio_exps_tpu_torch.configs import transformer_config
from owl_audio_exps_tpu_torch.models.audiorft import AudioRFTCore
from owl_audio_exps_tpu_torch.nn.wquant import quantize_params_int8
from owl_audio_exps_tpu_torch.sampling import get_sampler_cls
import bench_torch
cfg = transformer_config(model_id="audio_rft", n_layers=2, n_heads=2,
    d_model=32, channels=4, tokens_per_frame=1, n_frames=16, causal=True,
    uncond=True, has_audio=True, rope_impl="audio1d", local_window=4,
    kv_quant="int8")
core = quantize_params_int8(AudioRFTCore(cfg, dtype=torch.float32,
                                         device="cpu"), min_elems=256)
sampler = get_sampler_cls("audio_caching")(n_steps=2, num_tokens=3,
                                           max_window=6)
out = sampler(core, torch.zeros(1, 4, 4), generator=torch.Generator())
assert out.shape == (1, 7, 4) and torch.isfinite(out).all()
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "owl_audio_exps_tpu")]
print("FORBIDDEN", bad)
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "FORBIDDEN []" in res.stdout


def test_cached_serve_runs_without_importing_jax():
    code = """
import sys, numpy as np, torch
from owl_audio_exps_tpu_torch.configs import transformer_config
from owl_audio_exps_tpu_torch.models.gamerft import GameRFTCore
from owl_audio_exps_tpu_torch.models.gamerft_audio import GameRFTAudioCore
from owl_audio_exps_tpu_torch.inference.pipeline import (
    AVCachedStreamingPipeline)
from owl_audio_exps_tpu_torch.sampling import get_sampler_cls
kw = dict(n_layers=2, n_heads=2, d_model=32, channels=4, sample_size=2,
    n_buttons=3, causal=True, local_window=2)
cfg = transformer_config(model_id="game_rft_audio", audio_channels=4,
    tokens_per_frame=5, has_audio=True, **kw)
core = GameRFTAudioCore(cfg, dtype=torch.float32, device="cpu")
pipe = AVCachedStreamingPipeline(core, cfg, window_frames=4,
    sampling_steps=2, device="cpu")
for _ in range(3):
    frame, audio, _ = pipe(np.zeros(2), np.zeros(3))
assert torch.isfinite(frame.float()).all() and audio.shape == (1, 4)
vcfg = transformer_config(model_id="game_rft", tokens_per_frame=4, **kw)
vcore = GameRFTCore(vcfg, dtype=torch.float32, device="cpu")
out = get_sampler_cls("av_caching")(n_steps=2, num_frames=2)(
    vcore, torch.zeros(1, 2, 4, 2, 2), torch.zeros(1, 4, 2),
    torch.zeros(1, 4, 3), generator=torch.Generator())
assert out.shape == (1, 4, 4, 2, 2) and torch.isfinite(out).all()
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "owl_audio_exps_tpu")]
print("FORBIDDEN", bad)
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "FORBIDDEN []" in res.stdout


def test_port_trainer_runs_without_importing_jax(tmp_path):
    code = f"""
import sys, torch
from owl_audio_exps_tpu_torch.configs import Config
from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
cfg = Config.from_dict({{"model": dict(model_id="game_rft", n_layers=2,
    n_heads=2, d_model=32, channels=4, sample_size=2, tokens_per_frame=4,
    n_buttons=3, causal=True, local_window=2, gradient_checkpointing=True,
    remat_granularity="group"),
    "train": dict(trainer_id="rft", data_id="synthetic_latent",
    data_kwargs=dict(window_length=4, channels=4, sample_size=2,
    n_buttons=3), target_batch_size=1, batch_size=1, opt="Muon",
    opt_kwargs=dict(momentum_dtype="bfloat16"), save_interval=2,
    checkpoint_dir={str(tmp_path)!r}, log_interval=1)}})
state = get_trainer_cls("rft")(cfg, device="cpu").train(max_steps=2)
assert state.step == 2
cfg.train.merge(dict(trainer_id="sforce_vid", update_ratio=1,
    min_rollout_frames=2, rollout_steps=2, vae_scale=1.0, opt="AdamW",
    opt_kwargs=dict(lr=1e-3)))
state = get_trainer_cls("sforce_vid")(cfg, device="cpu").train(max_steps=1)
assert state.step == 1
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "owl_audio_exps_tpu")]
print("FORBIDDEN", bad)
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "FORBIDDEN []" in res.stdout


def test_table_trainers_run_without_importing_jax(tmp_path):
    """The rft trainer reads a packed table it wrote (the native gather
    built and read too), and the av trainer takes a MeanFlow step."""
    code = f"""
import os, sys, numpy as np, torch
from owl_audio_exps_tpu_torch.configs import Config
from owl_audio_exps_tpu_torch.data import get_loader
from owl_audio_exps_tpu_torch.data.npy_table import NpyTable
from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
root = {str(tmp_path)!r}
table = NpyTable(os.path.join(root, "tbl"), columns=["video", "mouse",
    "buttons", "tarball", "pt_idx", "missing", "truncated", "seq_len"],
    array_columns=["video", "mouse", "buttons"])
rs = np.random.RandomState(0)
for i, n in enumerate((9, 6, 11)):
    table.append(video=rs.randn(n, 4, 2, 2).astype(np.float16),
        mouse=rs.randn(n, 2).astype(np.float32),
        buttons=np.zeros((n, 3), np.float32), tarball="t", pt_idx=i,
        missing=False, truncated=False, seq_len=n)
kw = dict(window_length=8, dataset_path=os.path.join(root, "tbl"),
    batch_columns=["video", "mouse", "buttons"])
vid, = next(iter(get_loader("cod", 2, **dict(kw, batch_columns=["video"]))))
assert vid.shape == (2, 8, 4, 2, 2) and vid.dtype == np.float32
model = dict(model_id="game_rft", n_layers=2, n_heads=2, d_model=32,
    channels=4, sample_size=2, tokens_per_frame=4, n_buttons=3,
    causal=True, local_window=2, audio_channels=4, has_audio=True)
train = dict(trainer_id="rft", data_id="sequence_packing", data_kwargs=kw,
    target_batch_size=1, batch_size=1, opt="AdamW", save_interval=100,
    checkpoint_dir=os.path.join(root, "ckpt"), log_interval=1)
cfg = Config.from_dict({{"model": model, "train": train}})
assert get_trainer_cls("rft")(cfg, device="cpu").train(max_steps=2).step == 2
cfg = Config.from_dict({{"model": dict(model, model_id="game_mft_audio",
    tokens_per_frame=5), "train": dict(train, trainer_id="av",
    data_id="synthetic_av", data_kwargs=dict(window_length=4, channels=4,
    audio_channels=4, sample_size=2, n_buttons=3))}})
assert get_trainer_cls("av")(cfg, device="cpu").train(max_steps=1).step == 1
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "owl_audio_exps_tpu")]
print("FORBIDDEN", bad)
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "FORBIDDEN []" in res.stdout


def test_vaes_and_their_trainer_run_without_importing_jax(tmp_path):
    code = f"""
import os, sys, numpy as np, torch
from owl_audio_exps_tpu_torch.configs import Config
from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
from owl_audio_exps_tpu_torch.utils.owl_vae_bridge import (
    DCAEVideoDecoder, get_audio_encoder_decoder, make_batched_decode_fn)
dec = DCAEVideoDecoder(latent_channels=4, block_out_channels=(8, 16),
    block_types=("ResBlock", "EfficientViTBlock"), layers_per_block=(1, 1),
    qkv_multiscales=((), (5,)), attention_head_dim=8, device="cpu")
frames = make_batched_decode_fn(dec, 2)(torch.zeros(1, 3, 4, 2, 2))
assert frames.shape == (1, 3, 4, 4, 3) and torch.isfinite(frames).all()
enc, adec = get_audio_encoder_decoder(device="cpu")
assert adec(enc(torch.zeros(1, 735, 2))).shape == (1, 735, 2)
root = {str(tmp_path)!r}
torch.save(torch.randn(3000, 2) * 0.1, os.path.join(root, "a_wf.pt"))
cfg = Config.from_dict({{"model": dict(model_id="audio_vae", channels=64),
    "train": dict(trainer_id="audio_vae", data_id="local_waveform",
    data_kwargs=dict(window_length=2940, root_dir=root), batch_size=1,
    target_batch_size=1, save_interval=100,
    checkpoint_dir=os.path.join(root, "ckpt"))}})
state = get_trainer_cls("audio_vae")(cfg, device="cpu").train(max_steps=1)
assert state.step == 1
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "owl_audio_exps_tpu")]
print("FORBIDDEN", bad)
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "FORBIDDEN []" in res.stdout


def test_slice15_entry_points_run_without_importing_jax(tmp_path):
    """The warm-cache writer, the sampling CLI and a profiled trainer
    step, in a process that never imports JAX."""
    code = f"""
import sys, numpy as np, torch, yaml, glob
from owl_audio_exps_tpu_torch.configs import Config
from owl_audio_exps_tpu_torch.data.npy_table import NpyTable
from owl_audio_exps_tpu_torch.inference import build_cache, test_sampling
from owl_audio_exps_tpu_torch.utils.profiling import trace_if
t = NpyTable({str(tmp_path / "t")!r}, columns=["video", "mouse", "buttons",
    "tarball", "pt_idx", "missing", "truncated", "seq_len"],
    array_columns=["video", "mouse", "buttons"])
t.append(video=np.zeros((6, 4, 2, 2), np.float16),
         mouse=np.zeros((6, 2), np.float32),
         buttons=np.zeros((6, 3), np.float32), tarball="d", pt_idx=0,
         missing=False, truncated=False, seq_len=6)
cfg = {{"model": {{"audio_channels": 4}}, "train": {{"data_id": "cod",
       "data_kwargs": {{"dataset_path": {str(tmp_path / "t")!r},
                        "window_length": 3,
                        "batch_columns": ["video", "mouse", "buttons"]}}}}}}
open({str(tmp_path / "c.yml")!r}, "w").write(yaml.safe_dump(cfg))
build_cache.main(["--config_path", {str(tmp_path / "c.yml")!r},
                  "--out_dir", {str(tmp_path / "cache")!r},
                  "--n_samples", "2"])
assert np.load({str(tmp_path / "cache" / "buffers_1.npz")!r})[
    "audio"].shape == (1, 3, 4)
raw = Config.from_yaml("configs/dit_v4_tpu_e2e.yml").to_dict()
raw["model"].update(n_layers=2, d_model=32, n_heads=2, n_frames=16)
open({str(tmp_path / "s.yml")!r}, "w").write(yaml.safe_dump(raw))
lat = test_sampling.main(["--config_path", {str(tmp_path / "s.yml")!r},
                          "--num_frames", "2", "--device", "cpu"])
assert lat.shape == (1, 10, 128, 8, 8)
with trace_if({str(tmp_path / "trace")!r}):
    torch.ones(3).sum()
assert glob.glob({str(tmp_path / "trace" / "*.pt.trace.json")!r})
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "jaxlib", "flax", "owl_audio_exps_tpu")]
print("FORBIDDEN", bad)
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "FORBIDDEN []" in res.stdout


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from owl_audio_exps_tpu_torch.configs import transformer_config
    from owl_audio_exps_tpu_torch.inference.pipeline import CausvidPipeline
    from owl_audio_exps_tpu_torch.models.gamerft_audio import (
        GameRFTAudioCore)
    cfg = transformer_config(model_id="game_rft_audio", n_layers=1,
                             n_heads=2, d_model=16, channels=4,
                             audio_channels=4, sample_size=2,
                             tokens_per_frame=5, n_buttons=3, has_audio=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GameRFTAudioCore(cfg)
    core = GameRFTAudioCore(cfg, dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CausvidPipeline(core, cfg)
    # the cached serve: the pipelines, and the cores that the cached
    # samplers (which follow their inputs' device) sample
    from owl_audio_exps_tpu_torch.inference.pipeline import (
        AVCachedStreamingPipeline, CachedStreamingPipeline)
    from owl_audio_exps_tpu_torch.models.gamerft import GameRFTCore
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AVCachedStreamingPipeline(core, cfg)
    vcfg = transformer_config(model_id="game_rft", n_layers=1, n_heads=2,
                              d_model=16, channels=4, sample_size=2,
                              tokens_per_frame=4, n_buttons=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GameRFTCore(vcfg)
    vcore = GameRFTCore(vcfg, dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CachedStreamingPipeline(vcore, vcfg)
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.trainers.rft_trainer import (
        AudioRFTTrainer, RFTTrainer)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RFTTrainer(Config.from_dict({"model": {"model_id": "game_rft"}}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AudioRFTTrainer(Config.from_dict({"model": {"model_id":
                                                    "audio_rft"}}))
    from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
    for trainer_id in ("causvid_vid", "sforce_vid", "ode_distill_vid"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_trainer_cls(trainer_id)(Config.from_dict(
                {"model": {"model_id": "game_rft"}}))
    from owl_audio_exps_tpu_torch.models.audiorft import AudioRFTCore
    acfg = transformer_config(model_id="audio_rft", n_layers=1, n_heads=2,
                              d_model=16, channels=4, tokens_per_frame=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AudioRFTCore(acfg)
    # the VAEs, their bridge, the VAE trainer and the game loop
    from owl_audio_exps_tpu_torch.inference.game_cv import main as game_main
    from owl_audio_exps_tpu_torch.nn.audio_vae import AudioVAE
    from owl_audio_exps_tpu_torch.nn.dcae import DCAEDecoder
    from owl_audio_exps_tpu_torch.utils.owl_vae_bridge import (
        DCAEVideoDecoder, PixelShuffleVideoDecoder, get_audio_encoder_decoder,
        get_decoder_only)
    for make in (AudioVAE, DCAEDecoder, DCAEVideoDecoder,
                 PixelShuffleVideoDecoder, get_audio_encoder_decoder,
                 lambda: get_decoder_only("dcae")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_trainer_cls("audio_vae")(Config.from_dict(
            {"model": {"model_id": "audio_vae"}}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        game_main(["--config_path", "configs/causvid.yml", "--headless"])
    # the loaders' batches go to the card, and the MeanFlow model's there
    from owl_audio_exps_tpu_torch.data.prefetch import device_prefetch
    from owl_audio_exps_tpu_torch.models.gamemft_audio import GameMFTAudio
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(device_prefetch(iter([[np.zeros(2, np.float32)]])))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GameMFTAudio(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_trainer_cls("rft")(Config.from_dict(
            {"model": {"model_id": "game_rft"},
             "train": {"data_id": "sequence_packing"}}))
    # the offline sampling CLI
    from owl_audio_exps_tpu_torch.inference.test_sampling import \
        main as sampling_main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sampling_main(["--config_path", "configs/dit_v4_tpu_e2e.yml"])


def test_bench_torch_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench would run")
    res = subprocess.run([sys.executable, "bench_torch.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "device='cpu'" in res.stderr
    assert "streaming_audio_rtf" not in res.stdout


@pytest.mark.parametrize("alone", [False, True],
                         ids=["in_repo", "script_alone"])
def test_chip_smoke_fails_without_a_card_or_the_repo(alone, tmp_path):
    if torch.cuda.is_available() and not alone:
        pytest.skip("a card is present: the smoke run would proceed")
    cwd = REPO
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
