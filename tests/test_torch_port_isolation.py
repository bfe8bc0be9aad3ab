"""The port stands alone: it imports torch, numpy and the standard library,
never JAX, flax or the JAX package, and it runs on the card unless the
caller asks for the CPU."""

import ast
import glob
import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "owl_audio_exps_tpu_torch", "**", "*.py"),
              recursive=True)) + ["chip_smoke.py"]
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
    assert os.path.exists(os.path.join(
        REPO, "owl_audio_exps_tpu_torch", "csrc", "frame_attention.cu"))
    assert len(PORT_FILES) > 15


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
