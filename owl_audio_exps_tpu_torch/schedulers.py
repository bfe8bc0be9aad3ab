"""LR schedules (counterpart of owl_audio_exps_tpu/schedulers.py).

``get_scheduler_cls(None)`` is None (constant LR, the reference's
contract); the named schedules follow the optax schedules the JAX package
builds, as functions of the step count (0 for the first step)."""

from __future__ import annotations

import math


def _linear(init: float, end: float, steps: int):
    return lambda count: init + (end - init) * min(max(count, 0), steps) / steps


def _join(schedules, boundaries):
    def fn(count):
        idx = sum(count >= b for b in boundaries)
        start = boundaries[idx - 1] if idx else 0
        return schedules[idx](count - start)
    return fn


def _cosine(base_lr, total_steps, warmup_steps=0, min_lr=0.0, **_):
    decay = max(total_steps - warmup_steps, 1)

    def cosine(count):
        frac = min(max(count, 0), decay) / decay
        return min_lr + (base_lr - min_lr) * 0.5 * (1 + math.cos(math.pi * frac))
    return _join([_linear(0.0, base_lr, max(warmup_steps, 1)), cosine],
                 [warmup_steps])


def get_scheduler_cls(scheduler_id):
    """None for null/None, else a factory(base_lr, **kwargs) -> fn(count)."""
    if scheduler_id is None or scheduler_id == "null":
        return None
    factories = {
        "cosine": _cosine,
        "linear": lambda base_lr, total_steps, warmup_steps=0, min_lr=0.0, **_:
            _join([_linear(0.0, base_lr, max(warmup_steps, 1)),
                   _linear(base_lr, min_lr,
                           max(total_steps - warmup_steps, 1))],
                  [warmup_steps]),
        "constant": lambda base_lr, **_: (lambda count: base_lr),
        "warmup_constant": lambda base_lr, warmup_steps=0, **_:
            _join([_linear(0.0, base_lr, max(warmup_steps, 1)),
                   lambda count: base_lr], [warmup_steps]),
    }
    if scheduler_id not in factories:
        raise ValueError(f"Invalid scheduler id: {scheduler_id}")
    return factories[scheduler_id]
