"""The port's dual-stream MMDiT (nn/mmattn.py) against the benchmark's
plain float32 reference of it (perfbench/reference/mmdit.py), its spans
and block counter, the benchmark's FLOP count of it, and the two cells
that run it and its 8-session serve neighbour (``mmdit_v2.train.w1000``,
``av_v5.serve.cached8``) through the harness on the CPU.

Everything runs on seeded weights at tiny widths with the cells' own
structure: 4 layers (a global layer and three local ones), d 32, 2
heads, sample size 2 (tpf V + 1 = 5), 6 frames under a causal global
window of 3 frames and a local one of 2. The port computes in float32
here; forwards, losses and gradients agree with the reference to
float32 reassociation (relative 1e-4 of each tensor's norm). The file
imports no JAX; the tests' conftest does, so the harness's check for it
is held to the modules a run loads beyond those.
"""

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from owl_audio_exps_tpu_torch.configs import Config  # noqa: E402
from owl_audio_exps_tpu_torch.models.gamerft_audio import \
    GameRFTAudio  # noqa: E402
from owl_audio_exps_tpu_torch.nn import mmattn  # noqa: E402
from owl_audio_exps_tpu_torch.utils import profiling  # noqa: E402
from perfbench import run as R  # noqa: E402
from perfbench.reference import mmdit as ref  # noqa: E402
from perfbench.reference.model import Prec, train_attend  # noqa: E402
from perfbench.reference.train import loss_of  # noqa: E402
from perfbench.weights import load_into, make_weights  # noqa: E402

CELL, SERVE = "mmdit_v2.train.w1000", "av_v5.serve.cached8"
TINY = dict(n_layers=4, d_model=32, n_heads=2, channels=8, audio_channels=6,
            sample_size=2, tokens_per_frame=5, local_window=2,
            global_window=3, n_frames=6)
FRAMES, BATCH, SEED = 6, 2, 2 ** 31 + 211
# the cells' overrides for a run of the harness at tiny widths
RUNS = {
    CELL: dict({f"config.model.{k}": v for k, v in TINY.items()},
               **{"workload.traffic.window_frames": FRAMES}),
    SERVE: dict({f"config.model.{k}": v for k, v in TINY.items()
                 if k not in ("global_window", "local_window", "n_frames")},
                **{"config.model.local_window": 3,
                   "config.model.n_frames": 4,
                   "config.model.rope_headroom": 12,
                   "workload.traffic.ring_frames": 8,
                   "workload.traffic.prime_frames": 8,
                   "workload.ref_ticks": 24, "workload.trace_ticks": 2}),
}


def configs(**model):
    cfg = json.loads((ROOT / "perfbench" / "configs" / "mmdit_v2.json")
                     .read_text())
    mc = dict(cfg["model"], **TINY, **model)
    return mc, cfg["train"]


def port_model(mc):
    model = GameRFTAudio(Config.from_dict({"model": mc}).model,
                         dtype=torch.float32, device="cpu", seed=None)
    load_into(model, make_weights(ref.mmdit_param_spec(mc, "core."), SEED,
                                  torch.float32, "cpu"))
    return model


def batch(mc):
    rs = np.random.RandomState(3)
    p = mc["sample_size"]
    return [rs.randn(BATCH, FRAMES, mc["channels"], p, p).astype(np.float32),
            rs.randn(BATCH, FRAMES, mc["audio_channels"]).astype(np.float32),
            rs.randn(BATCH, FRAMES, 2).astype(np.float32),
            (rs.rand(BATCH, FRAMES, mc["n_buttons"]) > 0.5)
            .astype(np.float32)]


def port_step(model, tc, b, seed=5):
    """The trainer's loss (scaled bf16 latents, draws from a generator)
    and its backward; the prediction dict."""
    vid, aud, mouse, btn = (torch.as_tensor(a) for a in b)
    out = model((vid / tc["vae_scale"]).to(torch.bfloat16),
                (aud / tc["audio_vae_scale"]).to(torch.bfloat16), mouse, btn,
                generator=torch.Generator().manual_seed(seed),
                return_dict=True)
    out["diffusion_loss"].backward()
    return out


def rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


@pytest.mark.parametrize("attn_impl", ["auto", "splash"])
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_port_matches_the_plain_reference(remat, attn_impl):
    """Outputs, loss and every parameter's gradient of the port's MMDiT
    (dense route, and K1's route through its plain version) against
    reference/mmdit.py on the same weights, batch and draws."""
    mc, tc = configs(gradient_checkpointing=remat, attn_impl=attn_impl)
    model = port_model(mc)
    b = batch(mc)
    out = port_step(model, tc, b)

    params = make_weights(ref.mmdit_param_spec(mc, "core."), SEED,
                          torch.float32, "cpu")
    for v in params.values():
        v.requires_grad_(True)
    rmodel = ref.MMDiTModel(mc, params, prefix="core.", remat=remat)
    loss = loss_of(rmodel, mc, tc, b, torch.Generator().manual_seed(5),
                   "cpu", "fp32")
    loss.backward()
    got, want = float(out["diffusion_loss"].detach()), float(loss.detach())
    assert abs(got - want) <= 1e-5 * abs(want)
    with torch.no_grad():
        attend = train_attend(mc, FRAMES * mc["tokens_per_frame"], None,
                              Prec(), "cpu")
        bf = (lambda x: x.to(torch.bfloat16).float())
        pv, pa = rmodel.av(bf(out["lerpd_video"]), bf(out["lerpd_audio"]),
                           bf(out["ts"]), torch.as_tensor(b[2]),
                           torch.as_tensor(b[3]), out["cfg_mask"], attend)
    assert rel(out["pred_video"], pv) < 1e-4
    assert rel(out["pred_audio"], pa) < 1e-4
    grads = dict(model.named_parameters())
    assert set(grads) == set(params)
    worst = max(rel(grads[k].grad, v.grad) for k, v in params.items())
    assert worst < 1e-4, worst


def test_spans_change_nothing_and_count_the_block_forwards():
    """A remat step under a profiler capture gives the loss and every
    gradient of the same step without one, bit for bit; the capture
    records one joint and one split span and three audio spans per block
    forward, and the block forwards are the forward's and remat's."""
    mc, tc = configs(gradient_checkpointing=True)
    b = batch(mc)
    plain = port_model(mc)
    out = port_step(plain, tc, b)
    traced = port_model(mc)
    profiling.clear_spans()
    mmattn.block_forwards = 0
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        got = port_step(traced, tc, b)
    recs = profiling.spans()
    assert mmattn.block_forwards == 2 * mc["n_layers"]
    counts = {n: sum(r["name"] == n for r in recs)
              for n in ("owl.mmdit.joint", "owl.mmdit.split",
                        "owl.mmdit.audio")}
    assert counts == {"owl.mmdit.joint": mmattn.block_forwards,
                      "owl.mmdit.split": mmattn.block_forwards,
                      "owl.mmdit.audio": 3 * mmattn.block_forwards}
    assert torch.equal(got["diffusion_loss"], out["diffusion_loss"])
    other = dict(traced.named_parameters())
    for name, p in plain.named_parameters():
        assert torch.equal(other[name].grad, p.grad), name
    profiling.clear_spans()
    # off: nothing recorded
    port_step(traced, tc, b)
    assert profiling.spans() == []


def test_flop_count_matches_the_counter():
    """perfbench/drivers/train_mmdit.py's forward matmul FLOPs against
    FlopCounterMode's mm and addmm on the tiny model; the dense route's
    attention (bmm) against every pair of every layer, which the
    benchmark counts by visible pairs instead."""
    from torch.utils.flop_counter import FlopCounterMode
    drv = R.load_module(ROOT / "perfbench" / "drivers" / "train_mmdit.py",
                        "train_mmdit_flops")
    mc, _ = configs()
    model = port_model(mc)
    vid, aud, mouse, btn = (torch.as_tensor(a) for a in batch(mc))
    t = torch.full((BATCH, FRAMES), 0.5)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model.core(vid, aud, t, mouse, btn)
    ops = {str(k).split(".")[-1]: v
           for k, v in counter.get_flop_counts()["Global"].items()}
    L, dh = FRAMES * mc["tokens_per_frame"], mc["d_model"] // mc["n_heads"]
    assert ops.get("mm", 0) + ops.get("addmm", 0) == \
        drv.matmul_flops(mc, FRAMES, BATCH)
    assert ops["bmm"] == mc["n_layers"] * 4 * dh * mc["n_heads"] * \
        BATCH * L * L
    assert set(ops) <= {"mm", "addmm", "bmm"}
    # the MMDiT's conditioning: one shared projection, not the DiT's
    # per-block adaLN and gates
    d, nl = mc["d_model"], mc["n_layers"]
    assert drv.matmul_flops(mc, FRAMES, BATCH) - \
        R.load_module(ROOT / "perfbench" / "flops.py", "pf").matmul_flops(
            mc, FRAMES, BATCH) == BATCH * FRAMES * (24 * d * d
                                                     - 12 * nl * d * d)


def test_the_written_geometry_takes_k1_on_every_layer():
    """At mmdit_v2's written 1,000 frames both windows take K1 on every
    layer: 32 forwards (block remat) and 16 dq and dkv a step."""
    from perfbench import flops as F
    mc = json.loads((ROOT / "perfbench" / "configs" / "mmdit_v2.json")
                    .read_text())["model"]
    _, launches = F.attention_bounds(mc, 1000, [None])
    assert launches == {"k1_fwd": 32, "k1_dq": 16, "k1_dkv": 16,
                        "band_fwd": 0, "band_bwd": 0}


@pytest.mark.parametrize("name", ["mmdit_joint_ms_per_step.train",
                                  "mmdit_audio_ms_per_step.train"])
def test_span_metrics_read_only_complete_records(name, monkeypatch):
    """Each span metric sums its spans' device ms a traced step, and
    reads None where the records do not match ``block_forwards`` (a
    record missing) or the program keeps no count."""
    from perfbench import phases
    from perfbench.trace import Trace
    read = R.load_module(ROOT / "perfbench" / "metrics" / f"{name}.py",
                         name.replace(".", "_")).read
    blocks, steps = 8, 2
    recs = ([{"name": phases.STEP, "device_ms": 1.0}] * steps
            + [{"name": n, "device_ms": 0.5} for n, k in
               (("owl.mmdit.joint", 1), ("owl.mmdit.split", 1),
                ("owl.mmdit.audio", 3)) for _ in range(k * blocks)])
    trace = Trace([("k", 0.0, 1.0)], [(phases.FORWARD, 0.0, 1.0)], 1.0)

    class Ctx:
        traced = {"steps": steps, "trace": trace, "block_forwards": blocks}

    monkeypatch.setattr(phases, "program_spans", lambda: list(recs))
    per_block = 2 if "joint" in name else 3
    assert read(Ctx) == pytest.approx(per_block * blocks * 0.5 / steps)
    own = "owl.mmdit.split" if "joint" in name else "owl.mmdit.audio"
    short = list(recs)
    short.remove(next(r for r in recs if r["name"] == own))
    monkeypatch.setattr(phases, "program_spans", lambda: list(short))
    assert read(Ctx) is None
    monkeypatch.setattr(phases, "program_spans", lambda: list(recs))
    Ctx.traced = dict(Ctx.traced, block_forwards=None)
    assert read(Ctx) is None


@pytest.fixture
def checkout(tmp_path, monkeypatch):
    """A copy of the benchmark beside the port, as a checkout of the
    repository holds them; the run's environment and the JAX check
    restored after."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    (root / "owl_audio_exps_tpu_torch").symlink_to(
        ROOT / "owl_audio_exps_tpu_torch")
    for k in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "CUDA_CACHE_PATH",
              "USE_FLAX", "USE_JAX"):
        monkeypatch.delenv(k, raising=False)
    loaded = set(R.forbidden_modules())
    real = R.forbidden_modules
    monkeypatch.setattr(R, "forbidden_modules",
                        lambda: sorted(set(real()) - loaded))
    return root


def run_small(root, name, trace=0):
    return R.run_cell(root, name, SEED, 0.3, trace, device="cpu",
                      overrides=RUNS[name])


@pytest.mark.parametrize("name", [CELL, SERVE])
def test_new_cell_runs_through_the_harness(name, checkout):
    got = run_small(checkout, name, trace=int(name == CELL))
    assert got["correct"] is True, got["checks"]
    if name == SERVE:
        assert {"serve_frames_per_s", "tick_ms_p95", "setup_s"} <= \
            set(got["metrics"])
        assert set(got["checks"]) == {"video_err", "audio_err"}
    else:
        assert "mfu.train" in got["metrics"]
        assert set(got["checks"]) == {"loss_gap", "grad_gap", "change_gap",
                                      "ema_gap"}


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_a_planted_training_fault_fails(fault, checkout, monkeypatch):
    """A step that leaves the parameters unchanged, or a loss over the
    first half of each window's frames (the batch is one row, so half of
    it is a half of its frames), fails the check."""
    from owl_audio_exps_tpu_torch.trainers.base import BaseTrainer
    from owl_audio_exps_tpu_torch.trainers.rft_trainer import AVRFTTrainer
    real_step, real_loss = BaseTrainer.train_step, AVRFTTrainer.loss_fn

    def unchanged(self, state, micro, gen, **kw):
        keep = {n: t.detach().clone()
                for n, t in state.model.named_parameters()}
        out = real_step(self, state, micro, gen, **kw)
        with torch.no_grad():
            for n, t in state.model.named_parameters():
                t.copy_(keep[n])
        return out

    def half(self, model, batch, generator):
        return real_loss(self, model, [b[:, :b.shape[1] // 2]
                                       for b in batch], generator)

    if fault == "unchanged":
        monkeypatch.setattr(BaseTrainer, "train_step", unchanged)
    else:
        monkeypatch.setattr(AVRFTTrainer, "loss_fn", half)
    got = run_small(checkout, CELL)
    assert got["correct"] is False
    if fault == "unchanged":
        assert got["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("pair", [(0, 1), (6, 7)])
def test_swapped_sessions_fail(pair, checkout, monkeypatch):
    """One tick of the window hands two sessions each other's answers;
    the check follows the first and the last session, so either swap
    shows."""
    from owl_audio_exps_tpu_torch.inference import pipeline
    real = pipeline.CachedStreamingPipeline._tick
    count = [0]
    idx = list(range(8))
    idx[pair[0]], idx[pair[1]] = pair[1], pair[0]

    def swapped(self, *a, **kw):
        out = real(self, *a, **kw)
        count[0] += 1
        if count[0] == 9:   # the window's first tick (8 warm up)
            out = tuple(o[idx] for o in out)
        return out

    monkeypatch.setattr(pipeline.CachedStreamingPipeline, "_tick", swapped)
    got = run_small(checkout, SERVE)
    assert got["correct"] is False
    assert got["checks"]["video_err"]["value"] > 0.5
