"""Weight-only int8 quantization for serving (counterpart of
owl_audio_exps_tpu/nn/wquant.py).

Every large matmul weight is stored as int8 with one scale per output
channel (amax over the fan-in, symmetric, the scale rounded to its storage
dtype before the division so that the quantize and dequantize sides use
the same scale). The consuming ``Linear`` (which also serves the fused QKV
projection) dequantizes on read, ``q * s`` in its compute dtype, and
multiplies with a plain ``torch.matmul``, as the JAX package leaves the
product to XLA.

The port's weights are ``Linear.weight`` [out, in], the transpose of the
JAX package's ``kernel`` [in, out], so its per-output-channel scales are
[out, 1] where the JAX package's are [1, out]. The JAX package also
quantizes the [layers, in, out] kernels of its scan-stacked layout; the
port keeps its layers unrolled, so every weight it quantizes is 2-D.

Serve only: optimizers, checkpoints and ``params_from_jax`` work on float
weights; quantize after loading, before handing the model to a sampler:

    core_q = quantize_params_int8(core)
"""

from __future__ import annotations

import copy

import torch
from torch import nn

_QMAX = 127.0


def quantize_kernel(w: torch.Tensor, scale_dtype=torch.bfloat16):
    """[..., out, in] float -> (q int8 [..., out, in], s [..., out, 1])."""
    wf = w.float()
    amax = wf.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp(amax / _QMAX, min=1e-8).to(scale_dtype)
    q = torch.round(wf / s.float())
    return torch.clamp(q, -_QMAX, _QMAX).to(torch.int8), s


def dequantize_kernel(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    """The read path of a quantized ``Linear``: ``q * s`` in ``dtype``."""
    return q.to(dtype) * s.to(dtype)


def quantize_params_int8(module: nn.Module, min_elems: int = 65536,
                         scale_dtype=torch.bfloat16) -> nn.Module:
    """A serve-time copy of ``module`` whose every ``Linear`` with a float
    weight of at least ``min_elems`` elements stores it as int8. Biases,
    norms and small projections stay float."""
    from .layers import Linear
    out = copy.deepcopy(module)
    for m in out.modules():
        if isinstance(m, Linear) and m.weight is not None \
                and m.weight.is_floating_point() \
                and m.weight.numel() >= min_elems:
            m.quantize_(scale_dtype)
    return out


def is_quantized_kernel(v) -> bool:
    """Whether ``v`` holds an int8 weight: a ``Linear`` whose weight was
    replaced by ``weight_q`` / ``weight_s``, or a mapping with ``q`` and
    ``s`` (the JAX package's quantized kernel)."""
    from collections.abc import Mapping
    from .layers import Linear
    if isinstance(v, Linear):
        return v.weight is None and hasattr(v, "weight_q")
    return isinstance(v, Mapping) and "q" in v and "s" in v


def quantized_names(module: nn.Module):
    """Names of the ``Linear`` modules that hold int8 weights."""
    from .layers import Linear
    return sorted(name for name, m in module.named_modules()
                  if isinstance(m, Linear) and is_quantized_kernel(m))
