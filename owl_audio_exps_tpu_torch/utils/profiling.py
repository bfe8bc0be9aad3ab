"""torch.profiler capture of training steps (counterpart of
owl_audio_exps_tpu/utils/profiling.py).

Usage:
    with trace_if("runs/profile"):   # a no-op when the directory is falsy
        metrics = trainer.train_step(...)
or through the train config: ``train.profile_dir`` and
``train.profile_start`` (trainers/rft_trainer.py), which trace steps
``profile_start`` to ``profile_start + 3``.

Each capture records the host's and, when a card is present, the
device's activity and writes one Chrome trace per rank under the
directory, ``rank<r>_<ns>.pt.trace.json`` (open it in Perfetto or
chrome://tracing; a kernel is an event of category ``kernel``). The
device is synchronized before the capture stops, so the traced steps'
kernels are in the file.

``span(name, step)`` marks a phase of the program (trainers/base.py,
trainers/rft_trainer.py, data/prefetch.py). While a capture runs, from
this module or any other caller of torch.profiler, it opens a
``record_function`` range, so the phase lies on the trace's clock beside
its kernels, records two CUDA timing events on the current stream and
keeps a record (name, enclosing span, step, host start and end).
Otherwise, and inside a CUDA-graph capture, it is one flag check. At
most ``MAX_SPANS`` records are kept between clears; ``dropped`` counts
those past the cap. ``spans()`` reads the records with their device ms;
each capture clears them at its start and writes them with ``dropped``
beside its trace as ``rank<r>_<ns>.spans.json``.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch

from ..parallel.dist import process_index


MAX_SPANS = 1 << 16

_NULL = contextlib.nullcontext()
_records: List["_Record"] = []
dropped = 0                   # records past MAX_SPANS since the last clear
_open = threading.local()     # each thread's stack of open records


class _Record:
    __slots__ = ("name", "parent", "step", "t0", "t1", "start", "end")

    def __init__(self, name, parent, step, t0, start):
        self.name, self.parent, self.step = name, parent, step
        self.t0, self.t1 = t0, None
        self.start, self.end = start, None


def _timing_event():
    if not torch.cuda.is_initialized():
        return None
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


@contextlib.contextmanager
def _recorded(name: str, step):
    global dropped
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    with torch.profiler.record_function(name):
        rec = _Record(name, stack[-1].name if stack else None, step,
                      time.perf_counter_ns(), _timing_event())
        if len(_records) < MAX_SPANS:
            _records.append(rec)
        else:
            dropped += 1
        stack.append(rec)
        try:
            yield
        finally:
            stack.pop()
            rec.end = _timing_event()
            rec.t1 = time.perf_counter_ns()


def span(name: str, step: Optional[int] = None):
    """A context that records the phase ``name`` of step ``step`` while a
    torch.profiler capture runs, and does nothing otherwise (see the
    module's docstring)."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    if torch.cuda.is_initialized() and \
            torch.cuda.is_current_stream_capturing():
        return _NULL
    return _recorded(name, step)


def spans() -> List[Dict]:
    """The records of the spans closed since the last clear, in the order
    they opened: name, parent (the enclosing span's name or None), step,
    host_start_ns, host_end_ns and device_ms (between the span's two
    events; None without a card). Read after the device has finished the
    spans' work (a capture syncs before it stops)."""
    out = []
    for r in list(_records):
        if r.t1 is None:
            continue
        ms = None
        if r.start is not None and r.end is not None:
            r.end.synchronize()
            ms = r.start.elapsed_time(r.end)
        out.append({"name": r.name, "parent": r.parent, "step": r.step,
                    "host_start_ns": r.t0, "host_end_ns": r.t1,
                    "device_ms": ms})
    return out


def clear_spans():
    global dropped
    _records.clear()
    dropped = 0


def _activities():
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _start():
    clear_spans()
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    return prof


def _stop(prof, trace_dir: str) -> str:
    """Stop ``prof`` after the device has finished and write its trace
    and the spans' records under ``trace_dir``; returns the trace's
    path."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(trace_dir, exist_ok=True)
    stem = os.path.join(trace_dir,
                        f"rank{process_index()}_{time.time_ns()}")
    prof.export_chrome_trace(stem + ".pt.trace.json")
    with open(stem + ".spans.json", "w") as f:
        json.dump({"spans": spans(), "dropped": dropped}, f)
    return stem + ".pt.trace.json"


@contextlib.contextmanager
def trace_if(trace_dir: Optional[str]):
    if not trace_dir:
        yield
        return
    prof = _start()
    try:
        yield
    finally:
        _stop(prof, trace_dir)


class StepProfiler:
    """Capture a trace of steps [start, start + count]: started before
    step ``start`` runs, stopped after the first step >= start + count
    (the JAX package's window)."""

    def __init__(self, trace_dir: Optional[str], start: int = 10,
                 count: int = 3):
        self.trace_dir = trace_dir
        self.start = start
        self.stop_at = start + count
        self.path: Optional[str] = None
        self._prof = None

    def maybe_start(self, step: int):
        if self.trace_dir and self._prof is None and step == self.start:
            self._prof = _start()

    def maybe_stop(self, step: int):
        if self._prof is not None and step >= self.stop_at:
            self.path = _stop(self._prof, self.trace_dir)
            self._prof = None
