"""The readers of the training step's phases (perfbench/phases.py and the
seven metric files that call it) on fabricated span records and a
hand-made ``Trace``: busy device ms by phase, idle by the innermost
open phase, the wait's share, each per traced step, and None where the
program recorded nothing or records that do not match the slice."""

import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import phases  # noqa: E402
from perfbench import run as R  # noqa: E402
from perfbench.trace import Trace  # noqa: E402

NONE_OPEN = "host (no operation open)"   # Trace.idle_gaps's name

READERS = ("forward_ms_per_step.train", "backward_ms_per_step.train",
           "update_ms_per_step.train", "forward_idle_ms_per_step.train",
           "backward_idle_ms_per_step.train", "update_idle_ms_per_step.train",
           "prefetch_wait_share.train")


def reader(name):
    return R.load_module(ROOT / "perfbench" / "metrics" / f"{name}.py",
                         f"test_metric_{name.replace('.', '_')}").read


def rec(name, step, t0, t1, ms=None, parent="owl.train.step"):
    return {"name": name, "parent": parent, "step": step,
            "host_start_ns": t0, "host_end_ns": t1, "device_ms": ms}


def two_steps():
    """Two steps (us): the step spans [0, 100] and [100, 200]; in each a
    forward [s+10, s+40], a backward [s+40, s+70], an update [s+70, s+95]
    holding an optimizer [s+75, s+90]. Device operations leave gaps at
    [s+20, s+30] (forward), [s+50, s+54] (backward), [s+80, s+82]
    (optimizer, inside the update) and [s+96, s+100] (the step, after
    its phases; the second at the window's end)."""
    dev, host = [], [("bench.train_step", 0, 200)]
    for s in (0, 100):
        dev += [("k", s, s + 20), ("k", s + 30, s + 50), ("k", s + 54, s + 80),
                ("k", s + 82, s + 96)]
        host += [("owl.train.step", s, s + 100),
                 ("owl.train.forward", s + 10, s + 40),
                 ("owl.train.backward", s + 40, s + 70),
                 ("owl.train.update", s + 70, s + 95),
                 ("owl.train.optimizer", s + 75, s + 90),
                 ("aten::mm", s + 21, s + 29)]
    return Trace(dev, host, 200e-6)


def ctx_of(trace, steps=2):
    return types.SimpleNamespace(
        traced={"trace": trace, "steps": steps}, window={}, driver=None)


def test_idle_goes_to_the_innermost_open_phase():
    by = phases.idle_by_span(two_steps(), phases.PHASES)
    assert by == pytest.approx({phases.FORWARD: 20e-6,
                                phases.BACKWARD: 8e-6,
                                phases.UPDATE: 4e-6, NONE_OPEN: 8e-6})
    # the step alone among the names: every gap is inside one
    assert phases.idle_by_span(two_steps(), ("owl.train.step",)) == \
        pytest.approx({"owl.train.step": 40e-6})
    assert sum(phases.idle_by_span(two_steps(), ()).values()) == \
        pytest.approx(two_steps().window_s - two_steps().busy_s())


def test_idle_by_span_keeps_the_windows_start():
    """The window starts at the trace's first host operation, before any
    phase and any device operation: the gap there is counted, outside
    every phase; a trace without device operations has no gaps."""
    tr = Trace([("k", 20, 30), ("k", 40, 100)],
               [("bench.train_step", 0, 100), (phases.FORWARD, 25, 50)],
               100e-6)
    by = phases.idle_by_span(tr, phases.PHASES)
    assert by == pytest.approx({phases.FORWARD: 10e-6, NONE_OPEN: 20e-6})
    assert sum(by.values()) == pytest.approx(tr.window_s - tr.busy_s())
    assert phases.idle_by_span(Trace([], [("x", 0, 10)], 1e-5),
                               phases.PHASES) == {}


@pytest.mark.parametrize("steps", [1, 2, 4])
def test_idle_readers_divide_by_the_traced_steps(steps):
    ctx = ctx_of(two_steps(), steps)
    got = [reader(f"{p}_idle_ms_per_step.train")(ctx)
           for p in ("forward", "backward", "update")]
    assert got == pytest.approx([20e-3 / steps, 8e-3 / steps,
                                 4e-3 / steps])


PHASE_RECORDS = [rec(phases.FORWARD, 0, 0, 1, 10.0),
                 rec(phases.BACKWARD, 0, 1, 2, 20.0),
                 rec(phases.UPDATE, 0, 2, 3, 5.0),
                 rec("owl.train.optimizer", 0, 2, 3, 4.0, phases.UPDATE),
                 rec(phases.FORWARD, 1, 3, 4, 12.0),
                 rec(phases.BACKWARD, 1, 4, 5, 22.0),
                 rec(phases.UPDATE, 1, 5, 6, 7.0)]


def steps_of(n):
    return [rec(phases.STEP, i, 0, 1, 1.0, None) for i in range(n)]


@pytest.mark.parametrize("steps", [1, 2])
def test_device_readers_are_the_spans_events_less_their_idle(monkeypatch,
                                                             steps):
    """The events' ms summed over the traced steps, per step, less the
    phase's idle a step (two_steps: 20, 8 and 4 us in all)."""
    monkeypatch.setattr(phases, "program_spans",
                        lambda: PHASE_RECORDS + steps_of(steps))
    ctx = ctx_of(two_steps(), steps)
    assert [reader(f"{p}_ms_per_step.train")(ctx)
            for p in ("forward", "backward", "update")] == \
        pytest.approx([(22.0 - 0.020) / steps, (42.0 - 0.008) / steps,
                       (12.0 - 0.004) / steps])


def test_records_of_another_step_count_or_with_drops_read_none(
        monkeypatch):
    """Records that hold more or fewer steps than the slice ran (a second
    capture in the process), or a program that dropped records past its
    cap: no number from the records."""
    from owl_audio_exps_tpu_torch.utils import profiling
    for n in (1, 3):
        monkeypatch.setattr(phases, "program_spans",
                            lambda n=n: PHASE_RECORDS + steps_of(n)
                            + [rec(phases.WAIT, None, 0, 1, parent=None)])
        for name in ("forward_ms_per_step.train",
                     "prefetch_wait_share.train"):
            assert reader(name)(ctx_of(two_steps(), 2)) is None, name
    monkeypatch.undo()
    profiling.clear_spans()
    with torch.profiler.profile():
        with profiling.span(phases.STEP, 0):
            pass
    assert len(phases.program_spans()) == 1
    monkeypatch.setattr(profiling, "dropped", 1)
    assert phases.program_spans() == []
    profiling.clear_spans()


def test_wait_share_is_the_waits_host_time_over_the_window(monkeypatch):
    recs = [rec(phases.WAIT, None, 0, 4_000, parent=None),
            rec(phases.WAIT, None, 100_000, 106_000, parent=None),
            rec(phases.FORWARD, 0, 10_000, 40_000, 1.0)] + steps_of(2)
    monkeypatch.setattr(phases, "program_spans", lambda: recs)
    tr = Trace([("k", 0, 10)], [], 200e-6)
    assert reader("prefetch_wait_share.train")(ctx_of(tr)) == \
        pytest.approx(100.0 * 10e-6 / 200e-6)


def test_every_reader_is_none_without_records(monkeypatch):
    """No span records, spans without device times (the CPU), a trace
    without the phases' ranges (a program without spans) or without
    device operations, or no traced slice: no number."""
    bare = Trace([("k", 0, 10), ("k", 20, 30)],
                 [("bench.train_step", 0, 40), ("aten::mm", 11, 19)], 40e-6)
    no_device = Trace([], [(phases.FORWARD, 0, 10)], 10e-6)
    cpu = [rec(n, 0, 0, 1) for n in (phases.FORWARD, phases.BACKWARD,
                                     phases.UPDATE)]
    for records in ([], cpu):
        monkeypatch.setattr(phases, "program_spans", lambda r=records: r)
        for tr in (bare, no_device):
            for name in READERS:
                assert reader(name)(ctx_of(tr)) is None, name
        for name in READERS:
            assert reader(name)(types.SimpleNamespace(traced=None)) is None


def test_no_records_from_a_program_without_spans(monkeypatch):
    """The program's module without ``spans`` (the parent commit's) or
    without the port at all reads as no records."""
    from owl_audio_exps_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "spans")
    assert phases.program_spans() == []
    monkeypatch.setitem(sys.modules, "owl_audio_exps_tpu_torch.utils", None)
    assert phases.program_spans() == []


def test_spans_of_a_traced_cpu_step_reach_the_readers():
    """The port's own records under the profiler, on the CPU: the wait
    share reads them; the device readers find no events and read
    None."""
    from owl_audio_exps_tpu_torch.data.prefetch import device_prefetch
    from owl_audio_exps_tpu_torch.utils import profiling
    profiling.clear_spans()
    with torch.profiler.profile():
        for i, _ in enumerate(device_prefetch(iter([[np.zeros(2)]] * 2),
                                              "cpu")):
            with profiling.span(phases.STEP, i):
                pass
    tr = Trace([("k", 0, 10)], [], 1.0)
    assert reader("prefetch_wait_share.train")(ctx_of(tr)) > 0
    assert reader("forward_ms_per_step.train")(ctx_of(tr)) is None
    profiling.clear_spans()
