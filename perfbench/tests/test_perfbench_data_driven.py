"""A new configuration, traffic mix, cell and per-layer metric enter the
benchmark as new files and new BENCHMARK.json entries alone: in a copy
of the benchmark, the harness resolves them by name and runs the new
cell on the CPU (the drivers' CPU path, tiny widths), and no file that
was there changes."""

import hashlib
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import run as R  # noqa: E402

TINY = {"n_layers": 4, "d_model": 32, "n_heads": 2, "channels": 8,
        "audio_channels": 6, "sample_size": 2, "tokens_per_frame": 5,
        "local_window": 3, "n_frames": 4, "rope_headroom": 12}


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_is_new_files_only(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    (root / "owl_audio_exps_tpu_torch").symlink_to(
        ROOT / "owl_audio_exps_tpu_torch")
    before = digests(root / "perfbench")
    bench_before = (root / "BENCHMARK.json").read_text()

    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "av_v5.json").read_text())
    cfg["model"].update(TINY)
    cfg["train"].update(batch_size=2, target_batch_size=2)
    cfg["reduced"] = sorted(set(cfg["reduced"]) | set(TINY))
    (pb / "configs" / "av_tiny.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "w4b2.json").write_text(json.dumps(
        {"source": "synthetic_av", "window_frames": 4}))
    (pb / "workloads" / "av_tiny.train.w4b2.json").write_text(json.dumps(
        {"driver": "train", "check_steps": 2, "ref_steps": 2,
         "trace_steps": 1,
         "limits": {"loss_gap": 0.5, "grad_gap": 0.5, "change_gap": 1.5,
                    "ema_gap": 1.5}}))
    (pb / "metrics" / "steps_done.train.py").write_text(
        '"""Steps the window completed."""\n\n\n'
        'def read(ctx):\n    return float(ctx.window["steps"])\n')
    bench = json.loads(bench_before)
    bench["configs"].append({"name": "av_tiny", "source": "https://example.org/av_tiny",
                             "file": "perfbench/configs/av_tiny.json",
                             "reduced": cfg["reduced"], "why": "a test"})
    cell = "av_tiny.train.w4b2"
    bench["workloads"].append({"name": cell, "config": "av_tiny",
                               "traffic": "w4b2", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"].startswith("train_"):
            m["workloads"].append(cell)
    bench["per_layer"].append({"name": "steps_done.train", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "trainer loop",
                               "moves": "train_tokens_per_s",
                               "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    resolved = R.Cell(root, cell)
    assert resolved.config["model"]["d_model"] == 32
    assert resolved.workload["traffic"]["window_frames"] == 4
    assert "steps_done.train" in resolved.readers

    traced = R.run_cell(root, cell, 2 ** 31 + 5, 0.5, 1, device="cpu")
    assert traced["metrics"]["steps_done.train"]["value"] >= 1
    assert set(traced["checks"]) == {"loss_gap", "grad_gap", "change_gap",
                                     "ema_gap"}
    plain = R.run_cell(root, cell, 2 ** 31 + 6, 0.5, 0, device="cpu")
    assert {"setup_s", "train_tokens_per_s",
            "train_peak_mem_gib"} <= set(plain["metrics"])

    after = digests(root / "perfbench")
    assert {k: v for k, v in after.items() if k in before} == before
    old = json.loads(bench_before)
    new = json.loads((root / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads", "per_layer"):
        assert new[key][:len(old[key])] == old[key]
