"""Checkpoint save/load with ``torch.save`` (counterpart of
owl_audio_exps_tpu/utils/checkpoints.py, which uses orbax).

A checkpoint is one file holding {"params", "ema_params", "opt_state",
"step"}: parameter and EMA state dicts, the optimizer's state dict and
the step count. Files are written to a temporary name and renamed, so a
crash mid-save never leaves a torn checkpoint under the final name.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location=None) -> Dict[str, Any]:
    """Load a checkpoint written by ``save_checkpoint`` (tensors only, so
    ``weights_only`` loading suffices)."""
    return torch.load(os.path.abspath(path), map_location=map_location,
                      weights_only=True)


def save_clean_export(path: str, ema_params: Dict[str, torch.Tensor]) -> None:
    """EMA-only export for inference: ``<path>/params.pt``."""
    save_checkpoint(os.path.join(path, "params.pt"), {"params": ema_params})
