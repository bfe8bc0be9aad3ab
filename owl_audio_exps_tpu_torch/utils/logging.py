"""Metric accumulation and experiment logging (counterpart of
owl_audio_exps_tpu/utils/logging.py).

``LogHelper`` averages scalar metrics per key and keeps the last value of
an array metric (the ``watch`` histograms); ``DeferredMetrics`` holds the
device values of the steps since the last drain, so the host waits
for the device once per logging window; ``ExperimentLogger`` prints one
line per log call to stdout (the port has no wandb sink).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np


class LogHelper:
    """Accumulate scalar metrics; pop() returns the per-key means."""

    def __init__(self):
        self._sums: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._arrays: Dict[str, np.ndarray] = {}

    def log(self, key: str, value):
        if getattr(value, "ndim", 0) > 0:   # histograms: the last one wins
            self._arrays[key] = value
            return
        v = float(value)
        self._sums[key] = self._sums.get(key, 0.0) + v
        self._counts[key] = self._counts.get(key, 0) + 1

    def log_dict(self, d: Dict[str, float]):
        for k, v in d.items():
            self.log(k, v)

    def pop(self) -> Dict[str, float]:
        out = {k: self._sums[k] / max(self._counts[k], 1) for k in self._sums}
        out.update(self._arrays)
        self._sums.clear()
        self._counts.clear()
        self._arrays = {}
        return out


class DeferredMetrics:
    """Device-side metric buffer: the train loop appends tensors every
    step without a host sync and converts them to floats at the logging
    cadence."""

    def __init__(self):
        self._pending = []  # (step_idx, {key: tensor or float})

    def append(self, step_idx: int, metrics: Dict):
        self._pending.append((step_idx, metrics))

    def __len__(self):
        return len(self._pending)

    def drain(self):
        """Waits for the buffered values; returns [(step_idx, {key: float
        or numpy array})] and clears the buffer."""
        def host(v):
            if getattr(v, "ndim", 0) > 0:
                return v.detach().cpu().numpy()
            return float(v)

        out = [(s, {k: host(v) for k, v in m.items()})
               for s, m in self._pending]
        self._pending.clear()
        return out


class ExperimentLogger:
    """Prints ``[step N] key=value ...`` lines and keeps them in
    ``history``."""

    def __init__(self):
        self.history = []

    def log(self, metrics: Dict[str, float], step: Optional[int] = None):
        self.history.append(dict(metrics, step=step))
        print(f"[step {step}] " + " ".join(
            f"{k}={v:.5g}" for k, v in metrics.items()
            if isinstance(v, (int, float))), flush=True)


class Timer:
    """Wall-clock timer."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t = time.time()

    def hit(self) -> float:
        return time.time() - self._t

