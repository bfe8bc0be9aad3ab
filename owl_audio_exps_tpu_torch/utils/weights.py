"""JAX-package parameters -> the port's state_dict.

The port's own copy of the mapping in owl_audio_exps_tpu/utils/
torch_import.py (``export_torch_state_dict``,
``inverse_permute_qkv_rows``): flax module paths become dotted torch
names (``blocks_3`` -> ``blocks.3``), a flax ``kernel`` [in, out] becomes
the torch ``weight`` [out, in], norm ``scale``s become ``weight``s, and
the heads-major [H, 3, Dh] rows of every QKV projection are permuted back
to the torch reference's [3, H, Dh]. The port's modules load the result
with ``load_state_dict`` directly.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

_LISTS = ("blocks", "skip_projs", "qkv_projs", "out_projs", "mlps",
          "cond_proj")


def inverse_permute_qkv_rows(w: np.ndarray, n_heads: int) -> np.ndarray:
    """[H, 3, Dh] row order back to the torch reference's [3, H, Dh]."""
    three_d = w.shape[0]
    dh = three_d // 3 // n_heads
    w = w.reshape(n_heads, 3, dh, *w.shape[1:])
    return np.swapaxes(w, 0, 1).reshape(three_d, *w.shape[3:])


def params_from_jax(params: dict, n_heads: int) -> Dict[str, torch.Tensor]:
    """Nested {name: numpy array} flax params (optionally under a
    top-level "params" key) -> flat torch state_dict of float tensors."""
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [k])
            return
        leaf = path[-1]
        mod_path = []
        for p in path[:-1]:
            m = re.match(r"^(.*)_(\d+)$", p)
            if m and m.group(1) in _LISTS:
                mod_path.extend([m.group(1), m.group(2)])
            else:
                mod_path.append(p)
        value = np.asarray(node)
        is_qkv = len(path) > 1 and path[-2].startswith("qkv")
        if leaf == "kernel":
            if value.ndim == 2:
                value = value.T
                if is_qkv:
                    value = inverse_permute_qkv_rows(value, n_heads)
            leaf = "weight"
        elif leaf == "bias":
            if is_qkv and value.ndim == 1:
                value = inverse_permute_qkv_rows(value, n_heads)
        elif leaf == "scale":
            leaf = "weight"
        out[".".join(mod_path + [leaf])] = torch.from_numpy(np.array(value))

    walk(params, [])
    return out
