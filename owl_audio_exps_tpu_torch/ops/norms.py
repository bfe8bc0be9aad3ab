"""Functional norms (counterpart of owl_audio_exps_tpu/ops/norms.py): the
weightless ``rms_norm``, ``layer_norm`` and ``l2_norm``, and
``gained_rms_norm``, which scales by (1 + gain).

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


def l2_norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    xf = x.float()
    norm = torch.clamp(torch.linalg.vector_norm(xf, dim=-1, keepdim=True),
                       min=eps)
    return (xf / norm).to(x.dtype)


def gained_rms_norm(x: torch.Tensor, gain: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm scaled by (1 + gain)."""
    xf = x.float()
    scale = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (xf * scale * (1.0 + gain.float())).to(x.dtype)
