"""The benchmark's arithmetic at small shapes, its contract file, and its
isolation from JAX: visible pairs against a dense mask's sum, launches
and routes against the port's own rules, matmul FLOPs against
torch's FLOP counter, the metric readers against the names in
BENCHMARK.json."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import flops as F  # noqa: E402
from perfbench import run as R  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def dense_pairs(L, tpf, window, causal, doc):
    fid = np.arange(L) // tpf
    d = fid[:, None] - fid[None, :]
    m = np.ones((L, L), bool)
    if window is not None:
        m &= np.abs(d) < window
    if causal:
        m &= d >= 0
    if doc is not None:
        ids = np.asarray(doc)[fid]
        m &= ids[:, None] == ids[None, :]
    return int(m.sum())


@pytest.mark.parametrize("tpf,frames,window,causal,doc", [
    (4, 12, None, True, None),
    (4, 12, 3, True, None),
    (5, 10, 4, False, None),
    (4, 12, None, True, [0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 2]),
    (4, 12, 3, True, [0, 0, 1, 1, 1, 1, 1, 1, 2, 3, 3, 3]),
    (3, 9, None, False, [1, 1, 0, 0, 1, 1, 2, 2, 2]),
])
def test_visible_pairs_match_a_dense_mask(tpf, frames, window, causal, doc):
    from owl_audio_exps_tpu_torch.ops import splash
    want = dense_pairs(frames * tpf, tpf, window, causal, doc)
    assert F.visible_pairs(frames, tpf, window, causal, doc) == want
    assert splash.visible_pairs(frames * tpf, tpf, window, causal,
                                doc) == want


def config(name):
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("name,frames,packed", [
    ("dit_v4", 1536, True), ("dit_v4", 256, False), ("av_v5", 16, False)])
def test_launches_and_routes_follow_the_port(name, frames, packed):
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.nn.attn import (attention_forwards_per_step,
                                                  attention_route)
    cfg = config(name)
    mc = cfg["model"]
    conf = Config.from_dict(cfg)
    assert F.forwards_per_layer(mc) == attention_forwards_per_step(
        conf.model)
    L = frames * mc["tokens_per_frame"]
    doc = torch.zeros(1, frames, dtype=torch.int32) if packed else None
    for i, w in enumerate(F.layer_windows(mc)):
        route, _ = attention_route(conf.model, w is not None, L, doc)
        ours = F.attention_route(mc, w, L, packed)
        assert ours == ("k1" if route == "splash" else "band"), (i, route)


def test_attention_bounds_count_every_launch():
    mc = config("dit_v4")["model"]
    _, packed = F.attention_bounds(mc, 1536, [np.zeros(1536, int)])
    assert packed == {"k1_fwd": 44, "k1_dq": 16, "k1_dkv": 16,
                      "band_fwd": 0, "band_bwd": 0}
    _, plain = F.attention_bounds(mc, 256, [None])
    assert plain == {"k1_fwd": 12, "k1_dq": 4, "k1_dkv": 4,
                     "band_fwd": 32, "band_bwd": 12}


@pytest.mark.parametrize("audio", [False, True])
def test_matmul_flops_match_the_flop_counter(audio):
    from torch.utils.flop_counter import FlopCounterMode
    from perfbench.reference.model import Model, param_spec
    from perfbench.weights import make_weights
    mc = dict(sample_size=2, channels=8, audio_channels=6, n_layers=4,
              n_heads=2, d_model=32, tokens_per_frame=5 if audio else 4,
              n_buttons=3, has_audio=audio, uncond=False,
              local_window=2, n_frames=6)
    p = make_weights(param_spec(mc), 3, torch.float32, "cpu")
    m = Model(mc, p)
    b, n = 2, 6
    x = torch.randn(b, n, 8, 2, 2)
    args = (torch.rand(b, n), torch.randn(b, n, 2),
            torch.ones(b, n, 3), None, lambda i, loc, q, k, v: v)
    with FlopCounterMode(display=False) as fc:
        if audio:
            m.av(x, torch.randn(b, n, 6), *args)
        else:
            m.video(x, *args)
    assert fc.get_total_flops() == F.matmul_flops(mc, n, b)


def test_isolation_compares_whole_top_level_names(monkeypatch):
    import types
    for name in ("owl_audio_exps_tpu_torch_extra", "jaxtyping_like"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert R.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "owl_audio_exps_tpu.x",
                        types.ModuleType("owl_audio_exps_tpu.x"))
    monkeypatch.setitem(sys.modules, "jaxlib",
                        types.ModuleType("jaxlib"))
    assert R.forbidden_modules() == ["jaxlib", "owl_audio_exps_tpu"]


def test_a_run_loads_no_jax():
    """The harness, every driver, reader and reference module, and the
    port's modules that the drivers call, in a fresh process."""
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
from perfbench import run as R, control, trace
for w in R.json.loads((Path({str(ROOT)!r}) / "BENCHMARK.json").read_text())["workloads"]:
    R.Cell(Path({str(ROOT)!r}), w["name"])
import perfbench.reference.train, perfbench.reference.serve
import owl_audio_exps_tpu_torch.trainers.rft_trainer
import owl_audio_exps_tpu_torch.inference.pipeline
import owl_audio_exps_tpu_torch.data.latent_seq_packing
import owl_audio_exps_tpu_torch.data.synthetic
import owl_audio_exps_tpu_torch.ops.splash, owl_audio_exps_tpu_torch.ops.band
print(R.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "perfbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax",
                                   "owl_audio_exps_tpu",
                                   "owl_audio_exps_tpu_torch"), (path, n)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    cells = {w["name"]: w for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(cells)
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for c in m["workloads"]:
            assert c in e2e[m["moves"]].get("workloads", [c])
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").exists()
    for c in b["configs"]:
        assert (ROOT / c["file"]).exists() and NAME.match(c["name"])
        assert set(c["reduced"]) <= set(json.loads(
            (ROOT / c["file"]).read_text())["reduced"])
    for name, w in cells.items():
        assert NAME.match(name) and w["chips"] in (1, 4)
        assert (ROOT / "perfbench" / "workloads" / f"{name}.json").exists()
        assert (ROOT / "perfbench" / "traffic"
                / f"{w['traffic']}.json").exists()
        reports = [m for m in b["end_to_end"]
                   if name in m.get("workloads", [name])]
        assert "setup_s" in {m["name"] for m in reports}
        assert len(reports) >= 2
        assert any(name in m.get("workloads", [name])
                   for m in b["per_layer"])
    assert len(json.dumps(b)) < 64 * 1024


def test_trace_reduces_intervals_and_gaps():
    from perfbench.trace import Trace, kernel_class
    t = Trace([("frame_attn_fwd_kernel<64>", 10, 20),
               ("nvjet_tst_192x192", 30, 40), ("elementwise", 35, 50)],
              [("bench.tick", 0, 100), ("aten::mm", 22, 28)], 100e-6)
    assert t.busy_s() == pytest.approx(30e-6)
    assert dict(t.idle_gaps()) == pytest.approx({"bench.tick": 60e-6,
                                                 "aten::mm": 10e-6})
    assert t.seconds_by_class() == pytest.approx(
        {"attention": 10e-6, "matmul": 10e-6, "other": 15e-6})
    assert kernel_class("void band_attn_bwd_dq_kernel<64>") == "attention"
