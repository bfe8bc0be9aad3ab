"""The trainer's spans and the prefetcher's wait counter
(utils/profiling.py ``span``, trainers/base.py ``train_step``,
trainers/rft_trainer.py's loop, data/prefetch.py), on the CPU unless a
test says otherwise.

Off (no profiler capture running) a step records nothing, creates no
CUDA event and ends in the state the same step reaches under the
profiler, bit for bit. On, a step records each phase once with its
parent and its step, and both files of a capture hold them. The
prefetcher counts the batches it hands out, the gets that found none
ready and the seconds it blocked. The file imports no JAX, so its card
test also runs with ``--noconftest`` on the card.
"""

import glob
import json
import time

import numpy as np
import pytest
import torch

from owl_audio_exps_tpu_torch.configs import Config
from owl_audio_exps_tpu_torch.data import prefetch
from owl_audio_exps_tpu_torch.data.prefetch import device_prefetch
from owl_audio_exps_tpu_torch.models import get_model_cls
from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
from owl_audio_exps_tpu_torch.utils import profiling

PHASES = {"owl.train.step": None,
          "owl.train.forward": "owl.train.step",
          "owl.train.backward": "owl.train.step",
          "owl.train.update": "owl.train.step",
          "owl.train.reduce": "owl.train.update",
          "owl.train.clip": "owl.train.update",
          "owl.train.watch": "owl.train.update",
          "owl.train.optimizer": "owl.train.update",
          "owl.train.param_norm": "owl.train.update",
          "owl.train.ema": "owl.train.update"}

VIDEO = dict(model_id="game_rft", n_layers=2, n_heads=2, d_model=32,
             channels=4, sample_size=2, tokens_per_frame=4, n_frames=4,
             n_buttons=3, causal=True, uncond=False, has_audio=False,
             rope_impl="ortho", local_window=2, global_window=None,
             cfg_prob=0.1, backbone="dit")
AV = dict(model_id="game_rft_audio", n_layers=2, n_heads=2, d_model=32,
          channels=4, audio_channels=4, sample_size=2, tokens_per_frame=5,
          n_frames=8, n_buttons=11, causal=True, uncond=False,
          has_audio=True, rope_impl="ortho", local_window=2,
          global_window=None, cfg_prob=0.0)


def _config(kind, tmp_path, **train):
    model = VIDEO if kind == "rft" else AV
    data_kw = dict(window_length=4, channels=4, sample_size=2,
                   n_buttons=model["n_buttons"])
    if kind == "av":
        data_kw["audio_channels"] = 4
    return Config.from_dict({
        "model": dict(model),
        "train": dict(dict(
            trainer_id=kind,
            data_id="synthetic_latent" if kind == "rft" else "synthetic_av",
            data_kwargs=data_kw, target_batch_size=1, batch_size=1,
            opt="AdamW", opt_kwargs=dict(lr=1e-3), vae_scale=1.0,
            save_interval=1000, sample_interval=1000, log_interval=1,
            checkpoint_dir=str(tmp_path / "ckpt")), **train),
        "wandb": {"run_name": "spans"}})


def _one_step(kind, tmp_path, **train):
    """A trainer, its state on seed-0 weights and one call of its step
    on the first synthetic batch: (trainer, state, step)."""
    cfg = _config(kind, tmp_path, **train)
    trainer = get_trainer_cls(kind)(cfg, device="cpu")
    model = get_model_cls(cfg.model.model_id)(
        cfg.model, dtype=torch.bfloat16, device="cpu", seed=0)
    state = trainer.make_state(model.train())
    stream = trainer.data_stream(cfg.train.data_id, 1, cfg.train.data_kwargs)
    batch = next(stream)
    stream.close()

    def step():
        return trainer.train_step(state, [batch],
                                  torch.Generator().manual_seed(3),
                                  clip_norm=trainer.grad_clip_norm())
    return trainer, state, step


def _snapshot(state, metrics):
    opt = {f"o.{i}.{k}": v.clone() for i, s in
           enumerate(state.optimizer.state_dict()["state"].values())
           for k, v in s.items() if torch.is_tensor(v)}
    return {**{f"p.{k}": v.detach().clone() for k, v in
               state.model.state_dict().items()},
            **{f"e.{k}": v.clone() for k, v in state.ema.items()},
            **{f"m.{k}": torch.as_tensor(v).clone()
               for k, v in metrics.items()}, **opt}


@pytest.mark.parametrize("kind", ["rft", "av"])
def test_step_off_records_nothing_and_equals_the_traced_step(
        kind, tmp_path, monkeypatch):
    """Profiler off: no record, no CUDA event, no sync, even where the
    span would make events (a card taken as present); the state after
    the step (parameters, EMA, optimizer moments, metrics) equals the
    same step's under torch.profiler bit for bit."""
    made = []

    class CountedEvent:
        def __init__(self, *a, **kw):
            made.append("event")

    monkeypatch.setattr(torch.cuda, "Event", CountedEvent)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **kw: made.append("sync"))
    profiling.clear_spans()
    _, state, step = _one_step(kind, tmp_path, watch="norms")
    off = _snapshot(state, step())
    assert profiling.spans() == [] and made == []
    monkeypatch.undo()

    _, state, step = _one_step(kind, tmp_path, watch="norms")
    with torch.profiler.profile():
        on = _snapshot(state, step())
    assert {r["name"] for r in profiling.spans()} >= set(PHASES)
    profiling.clear_spans()
    assert set(off) == set(on)
    for k, v in off.items():
        assert torch.equal(v, on[k]), k


def test_traced_step_records_each_phase_in_its_parent(tmp_path):
    """Under trace_if one step (clip and watch on) records every phase
    once, with its parent and the step's number; the update's children
    lie inside it and the step's phases inside the step on the host's
    clock; the Chrome trace holds each name and the .spans.json file
    the same records."""
    _, state, step = _one_step("rft", tmp_path, watch="norms")
    state.step = 7
    with profiling.trace_if(str(tmp_path / "trace")):
        step()
    recs = profiling.spans()
    assert sorted(r["name"] for r in recs) == sorted(PHASES)
    by = {r["name"]: r for r in recs}
    for name, parent in PHASES.items():
        r = by[name]
        assert (r["parent"], r["step"], r["device_ms"]) == (parent, 7, None)
        assert r["host_start_ns"] <= r["host_end_ns"]
        if parent is not None:
            assert by[parent]["host_start_ns"] <= r["host_start_ns"]
            assert r["host_end_ns"] <= by[parent]["host_end_ns"]
    order = [r["name"] for r in recs]
    assert order[:4] == ["owl.train.step", "owl.train.forward",
                         "owl.train.backward", "owl.train.update"]
    (path,) = glob.glob(str(tmp_path / "trace" / "rank0_*.pt.trace.json"))
    traced = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert set(PHASES) <= traced
    (sp,) = glob.glob(str(tmp_path / "trace" / "rank0_*.spans.json"))
    assert sp == path.replace(".pt.trace.json", ".spans.json")
    assert json.load(open(sp)) == {"spans": recs, "dropped": 0}
    profiling.clear_spans()


def test_loop_spans_and_wait_counters_in_the_log(tmp_path):
    """The rft loop under StepProfiler (steps 1 to 4 of 6, a save every 2
    steps): the records hold the drain, the save and a wait for each
    traced batch, and every log reports the data wait since the last."""
    cfg = _config("rft", tmp_path, profile_dir=str(tmp_path / "trace"),
                  profile_start=1, save_interval=2)
    trainer = get_trainer_cls("rft")(cfg, device="cpu")
    logged = []
    trainer.logger.log = lambda log, step: logged.append(dict(log))
    trainer.train(max_steps=6)
    (sp,) = glob.glob(str(tmp_path / "trace" / "rank0_*.spans.json"))
    recs = json.load(open(sp))["spans"]
    names = [r["name"] for r in recs]
    assert names.count("owl.train.step") == 4
    assert sorted({r["step"] for r in recs
                   if r["name"] == "owl.train.step"}) == [1, 2, 3, 4]
    assert {"owl.train.drain", "owl.train.save", "owl.data.wait"} <= \
        set(names)
    assert all(r["parent"] is None for r in recs
               if r["name"] in ("owl.train.drain", "owl.train.save",
                                "owl.data.wait"))
    assert len(logged) == 6
    for log in logged:
        assert log["data/wait_s"] >= 0.0 and log["data/empty_gets"] >= 0
    # one batch a step, each taken once: the logs' counts add up to them
    assert sum(log["data/batches"] for log in logged) == 6


def test_records_past_the_cap_are_counted_as_dropped(monkeypatch):
    """Past ``MAX_SPANS`` records a span still opens its range but keeps
    no record; ``dropped`` counts it and a clear resets it."""
    monkeypatch.setattr(profiling, "MAX_SPANS", 2)
    profiling.clear_spans()
    with torch.profiler.profile() as prof:
        for i in range(3):
            with profiling.span("owl.test.capped", i):
                pass
    assert [r["step"] for r in profiling.spans()] == [0, 1]
    assert profiling.dropped == 1
    names = [e.name for e in prof.events()]
    assert names.count("owl.test.capped") == 3
    profiling.clear_spans()
    assert (profiling.spans(), profiling.dropped) == ([], 0)


def _batches(n, delay=0.0):
    for i in range(n):
        if delay:
            time.sleep(delay)
        yield [np.full((2,), i, np.float32)]


def test_prefetch_counts_the_wait_of_a_slow_source():
    """A source that takes 50 ms a batch: every get after the first
    finds the queue empty and the consumer blocks ~50 ms; each wait is an
    ``owl.data.wait`` span under the profiler."""
    b0, e0, w0 = prefetch.batches, prefetch.empty_gets, prefetch.wait_s
    profiling.clear_spans()
    with torch.profiler.profile():
        got = [int(b[0][0]) for b in device_prefetch(_batches(4, 0.05),
                                                     "cpu")]
    assert got == [0, 1, 2, 3]
    assert prefetch.batches - b0 == 4
    assert prefetch.empty_gets - e0 >= 4
    assert prefetch.wait_s - w0 >= 0.15
    waits = [r for r in profiling.spans() if r["name"] == "owl.data.wait"]
    assert len(waits) == 5       # the four batches and the end
    assert sum(r["host_end_ns"] - r["host_start_ns"]
               for r in waits) / 1e9 <= prefetch.wait_s - w0
    profiling.clear_spans()


def test_prefetch_counts_no_wait_of_a_ready_source():
    """A ready source read by a consumer slower than it (after the first
    batch, which starts the worker): no get finds the queue empty and the
    consumer hardly blocks."""
    it = device_prefetch(_batches(5), "cpu", size=2)
    got = [int(next(it)[0][0])]
    b0, e0, w0 = prefetch.batches, prefetch.empty_gets, prefetch.wait_s
    for _ in range(4):
        time.sleep(0.05)
        got.append(int(next(it)[0][0]))
    it.close()
    assert got == [0, 1, 2, 3, 4]
    assert prefetch.batches - b0 == 4
    assert prefetch.empty_gets - e0 == 0
    assert prefetch.wait_s - w0 < 0.02


@pytest.mark.cuda
def test_span_is_a_no_op_inside_a_graph_capture():
    """On the card: a span opened while the current stream captures a
    CUDA graph records nothing and adds no node; the replay computes
    what the captured work computes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    x = torch.ones(8, device="cuda")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        y = x * 2          # warm-up before the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    profiling.clear_spans()
    with torch.profiler.profile():
        with torch.cuda.graph(graph):
            with profiling.span("owl.test.captured", 0):
                y = x * 2
        assert profiling.spans() == []
        graph.replay()
        with profiling.span("owl.test.eager", 0):
            z = x + 1
        torch.cuda.synchronize()
    recs = profiling.spans()
    assert [r["name"] for r in recs] == ["owl.test.eager"]
    assert recs[0]["device_ms"] is not None and recs[0]["device_ms"] >= 0
    assert torch.equal(y, torch.full_like(x, 2.0))
    assert torch.equal(z, torch.full_like(x, 2.0))
    profiling.clear_spans()
