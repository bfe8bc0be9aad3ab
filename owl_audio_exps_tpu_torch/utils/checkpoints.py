"""Checkpoint save/load with ``torch.save`` (counterpart of
owl_audio_exps_tpu/utils/checkpoints.py, which uses orbax).

A checkpoint is one file holding {"params", "ema_params", "opt_state",
"step"}: parameter and EMA state dicts, the optimizer's state dict and
the step count (the distillation trainers add their critic's). Files are
written to a temporary name and renamed, so a crash mid-save never leaves
a torn checkpoint under the final name. ``versatile_load`` reads the
inference weights of either kind of file, or of a clean export's
directory, and ``unwrap_core`` takes a training wrapper's core out of
them; ``latest_step_dir`` finds the newest step in a directory. ``load_torch_file`` reads a state_dict in the torch reference's
layout (the port's own) from either, from an owl_wms checkpoint, or
from a reference golden's ``.npz``.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

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


def versatile_load(path: str, map_location=None) -> Dict[str, Any]:
    """The inference weights of a checkpoint: its ``ema_params``, else its
    ``params``, else the whole object (the JAX package's versatile_load).
    ``path`` is a ``save_checkpoint`` file, or the directory of a
    ``save_clean_export``, whose ``params.pt`` is read."""
    if os.path.isdir(path):
        path = os.path.join(path, "params.pt")
    state = load_checkpoint(path, map_location=map_location)
    for key in ("ema_params", "params"):
        if isinstance(state, dict) and key in state:
            return state[key]
    return state


def latest_step_dir(checkpoint_dir: str) -> Optional[str]:
    """The newest ``step_N`` entry of a directory (a JAX package's step
    directory, or the port trainer's ``step_N.pt``), None if it has
    none or does not exist."""
    if not os.path.isdir(checkpoint_dir):
        return None
    steps = []
    for name in os.listdir(checkpoint_dir):
        m = re.fullmatch(r"step_(\d+)(\.pt)?", name)
        if m:
            steps.append((int(m.group(1)), name))
    if not steps:
        return None
    return os.path.join(checkpoint_dir, max(steps)[1])


def unwrap_core(state_dict: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """A training wrapper's weights (``core.``-prefixed names, as
    ``GameRFT`` saves them) -> its core's state dict; a core's own state
    dict is returned as it is."""
    prefix = "core."
    if any(k.startswith(prefix) for k in state_dict):
        return {k[len(prefix):]: v for k, v in state_dict.items()
                if k.startswith(prefix)}
    return state_dict


# the state_dict entries of a reference golden (.npz)
_NPZ_PREFIX = "sd::"


def load_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """A state_dict in the torch reference's layout (the port's own) from
    a port checkpoint or export (``versatile_load``) or a torch file: the
    EMA, else the model, of an owl_wms {"model", "ema"} checkpoint, with
    the DDP, torch.compile and EMA-wrapper prefixes (``module.``,
    ``_orig_mod.``, ``ema_model.``) stripped, as the JAX package's
    ``load_torch_file`` and ``normalize_torch_keys`` read it. A ``.npz``
    holds the reference's state_dict under ``sd::<name>`` keys beside
    other arrays (the layout of the reference goldens, tests/goldens/
    *.npz); its names are the port's, so it loads directly."""
    if path.endswith(".npz"):
        import numpy as np
        with np.load(path) as z:
            return {k[len(_NPZ_PREFIX):]: torch.from_numpy(np.array(z[k]))
                    for k in z.files if k.startswith(_NPZ_PREFIX)}
    sd = versatile_load(path, map_location="cpu")
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        sd = sd.get("ema", sd["model"])
    return {re.sub(r"^ema_model\.", "", k).replace("_orig_mod.", "")
            .replace("module.", ""): v for k, v in sd.items()
            if torch.is_tensor(v)}
