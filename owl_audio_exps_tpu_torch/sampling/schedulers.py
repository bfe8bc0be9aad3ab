"""Sampling noise schedules (counterpart of
owl_audio_exps_tpu/sampling/schedulers.py).

``get_sd3_euler``: sigma_i = (n - i) / n for i = 0..n-1, time-shifted by
sigma' = shift * sigma / (1 + (shift - 1) * sigma), with a terminal 0;
returned as the per-step Euler deltas dt_i = t_i - t_{i+1}.
"""

from __future__ import annotations

import numpy as np


def get_sd3_euler(n_steps: int, shift: float = 3.0) -> np.ndarray:
    sigmas = np.arange(n_steps, 0, -1, dtype=np.float64) / n_steps
    ts = shift * sigmas / (1.0 + (shift - 1.0) * sigmas)
    ts = np.concatenate([ts, [0.0]])
    return (ts[:-1] - ts[1:]).astype(np.float32)


def get_deltas(custom_schedule) -> np.ndarray:
    """Custom schedule -> deltas, appending a terminal 0."""
    sched = list(custom_schedule)
    if sched[-1] != 0.0:
        sched = sched + [0.0]
    return np.asarray([abs(b - a) for a, b in zip(sched[:-1], sched[1:])],
                      dtype=np.float32)


def resolve_schedule(n_steps: int, custom_schedule=None) -> np.ndarray:
    if custom_schedule is not None:
        return get_deltas(custom_schedule)
    return get_sd3_euler(n_steps)


def scan_or_unroll(body, init, dt: np.ndarray):
    """Run ``body(state, dt_i) -> (state, None)`` over the static schedule
    ``dt`` in a Python loop (the JAX package's ``lax.scan`` or unrolled
    loop); ``dt_i`` is a Python float."""
    state = init
    for d in dt:
        state, _ = body(state, float(d))
    return state
