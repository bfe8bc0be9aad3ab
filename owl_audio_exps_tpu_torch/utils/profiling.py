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
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

from ..parallel.dist import process_index


def _activities():
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _start():
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    return prof


def _stop(prof, trace_dir: str) -> str:
    """Stop ``prof`` after the device has finished and write its trace
    under ``trace_dir``; returns the file's path."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"rank{process_index()}_"
                                   f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


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
