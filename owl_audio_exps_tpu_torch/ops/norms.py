"""Weightless functional norms (counterpart of owl_audio_exps_tpu/ops/norms.py).

Statistics accumulate in float32 and the result is cast back to the
input dtype.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    scale = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype)


def layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
