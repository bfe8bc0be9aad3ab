"""JAX-package parameters -> the port's state_dict.

The port's own copy of the mapping in owl_audio_exps_tpu/utils/
torch_import.py (``export_torch_state_dict``,
``inverse_permute_qkv_rows``): flax module paths become dotted torch
names (``blocks_3`` -> ``blocks.3``), a flax ``kernel`` [in, out] becomes
the torch ``weight`` [out, in], norm ``scale``s and an ``nn.Embed`` table
(``embedding``) become ``weight``s, and
the heads-major [H, 3, Dh] rows of every QKV projection are permuted back
to the torch reference's [3, H, Dh]. The port's modules load the result
with ``load_state_dict`` directly: ``GameRFTAudioCore`` and ``GameRFTCore``
from their own trees, the ``GameRFT`` training wrapper from its tree,
whose ``core`` subtree becomes the ``core.`` prefix (``GameMFTAudio`` the
same way, its interval embedding ``r_embed`` beside ``t_embed``), and
``AudioRFTCore`` from its tree (``t_embed``, ``proj_in``, ``transformer``,
``proj_out``).
The mapping is linear, so a tree of gradients maps the same way. Trees are
float: a tree quantized by the JAX package's ``quantize_params_int8`` is
refused; carry the float tree and quantize the port's module after
loading (nn/wquant.py).

``vae_params_from_jax`` does the same for the VAEs (nn/audio_vae.py,
nn/dcae.py and the bridge's pixel-shuffle decoder), whose convolution
kernels take their own transposes.

A tree of a ``scan_layers`` model, whose transformer keeps
``groups/blocks_j`` with every leaf stacked over [n_groups] (the layout
of owl_audio_exps_tpu/utils/layer_stacking.py), is unstacked first:
a group holds one period of the local/global alternation, so the period
is the number of ``blocks_j`` keys and group g's ``blocks_j`` is block
g * period + j.
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


def _index(node, g: int):
    if isinstance(node, dict):
        return {k: _index(v, g) for k, v in node.items()}
    return np.asarray(node)[g]


def unstack_groups(node):
    """Every ``transformer/groups/blocks_j`` (leaves stacked over
    [n_groups]) -> ``transformer/blocks_{g * period + j}``, the period
    being the number of ``blocks_j`` in the group."""
    if not isinstance(node, dict):
        return node
    out = {}
    for key, value in node.items():
        if key == "transformer" and isinstance(value, dict) \
                and "groups" in value:
            unrolled = {k: v for k, v in value.items() if k != "groups"}
            period = len(value["groups"])
            for name, stacked in value["groups"].items():
                j = int(name.rsplit("_", 1)[1])
                leaf = stacked
                while isinstance(leaf, dict):
                    leaf = next(iter(leaf.values()))
                for g in range(np.asarray(leaf).shape[0]):
                    unrolled[f"blocks_{g * period + j}"] = \
                        _index(stacked, g)
            out[key] = unrolled
        else:
            out[key] = unstack_groups(value)
    return out


def params_from_jax(params: dict, n_heads: int) -> Dict[str, torch.Tensor]:
    """Nested {name: numpy array} flax params (optionally under a
    top-level "params" key), unrolled or ``scan_layers``-stacked -> flat
    torch state_dict of float tensors."""
    if set(params) == {"params"}:
        params = params["params"]
    params = unstack_groups(params)
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict) and path and path[-1] == "kernel":
            raise ValueError(
                f"{'/'.join(path)} is an int8-quantized kernel: carry the "
                "float tree, then quantize the port's module "
                "(nn/wquant.py quantize_params_int8)")
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
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        out[".".join(mod_path + [leaf])] = torch.from_numpy(np.array(value))

    walk(params, [])
    return out


# flax's automatic names inside the audio VAE's ResBlock1D and the
# pixel-shuffle video decoder -> the port's module names
_VAE_RENAMES = {"GroupNorm_0": "norm1", "Conv_0": "conv1",
                "GroupNorm_1": "norm2", "Conv_1": "conv2"}
_VAE_INDEXED = re.compile(r"^(up_blocks)_(\d+)_(\d+)$"
                          r"|^(to_qkv_multiscale)_(\d+)_(proj_in|proj_out)$")


def vae_params_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """The JAX package's VAE params (``AudioVAE`` / ``AudioEncoder`` /
    ``AudioDecoder``, ``DCAEDecoder``, the bridge's pixel-shuffle
    decoder; optionally under a top-level "params" key) -> the port's
    state_dict of those modules: a 1-D conv or conv-transpose kernel [k,
    in, out] -> [out, in, k] (the port's ``UpConv1d`` keeps flax's
    un-flipped kernel), a 2-D conv kernel [kh, kw, in / g, out] -> [out,
    in / g, kh, kw], a ``Dense`` kernel transposed, norm ``scale`` ->
    ``weight``; ``up_blocks_i_j`` -> ``up_blocks.i.j``,
    ``to_qkv_multiscale_s_proj_in`` -> ``to_qkv_multiscale.s.proj_in``,
    and flax's ``GroupNorm_k`` / ``Conv_k`` -> ``norm{k+1}`` /
    ``conv{k+1}``."""
    if set(params) == {"params"}:
        params = params["params"]
    perms = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [k])
            return
        mod = []
        for p in path[:-1]:
            m = _VAE_INDEXED.match(p)
            if m:
                mod.extend(g for g in m.groups() if g is not None)
            else:
                mod.append(_VAE_RENAMES.get(p, p))
        leaf, value = path[-1], np.asarray(node)
        if leaf == "kernel":
            value, leaf = np.transpose(value, perms[value.ndim]), "weight"
        elif leaf == "scale":
            leaf = "weight"
        out[".".join(mod + [leaf])] = torch.from_numpy(np.array(value))

    walk(params, [])
    return out
