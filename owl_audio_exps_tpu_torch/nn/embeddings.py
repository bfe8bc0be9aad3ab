"""Condition embeddings (counterpart of owl_audio_exps_tpu/nn/embeddings.py).

* ``sincos_embed``: theta 300, mult 1000, [sin | cos] halves, float32;
* ``MouseEmbedding``: symlog deltas -> polar; the angle through a bias-free
  projection of [cos, sin], the magnitude through sincos;
* ``ButtonEmbedding``: {0, 1} -> {-1, 1} -> MLP;
* ``ControlEmbedding``: the sum of the two.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .layers import Linear, MLPCustom


def sincos_embed(x: torch.Tensor, dim: int, theta: float = 300.0,
                 mult: float = 1000.0) -> torch.Tensor:
    """[...] -> [..., dim] with [sin | cos] halves, in float32."""
    xf = x.float() * mult
    half = dim // 2
    emb = math.log(theta) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                   device=x.device) * -emb)
    ang = xf[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class TimestepEmbedding(nn.Module):
    """sincos(512) -> MLP(512, 4d, d); t is per frame [b, n]."""

    def __init__(self, dim: int, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.mlp = MLPCustom(512, 4 * dim, dim, dtype=dtype, device=device)

    def forward(self, t):
        return self.mlp(sincos_embed(t, 512).to(self.dtype))


class MouseEmbedding(nn.Module):
    """Mouse deltas [b, n, 2] -> [b, n, dim_out]."""

    def __init__(self, dim_out: int, dim: int = 512, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.dim = dim
        self.dtype = dtype
        self.angle_proj = Linear(2, dim // 2, bias=False, dtype=dtype,
                                 device=device)
        self.mlp = MLPCustom(dim, 4 * dim, dim_out, dtype=dtype,
                             device=device)

    def forward(self, x):
        xf = x.float()
        sym = torch.sign(xf) * torch.log1p(xf.abs())
        angles = torch.atan2(sym[..., 1], sym[..., 0])
        magnitudes = torch.linalg.vector_norm(sym, dim=-1)
        angle_emb = torch.stack([torch.cos(angles), torch.sin(angles)],
                                dim=-1).to(self.dtype)
        angle_emb = self.angle_proj(angle_emb)
        mag_emb = sincos_embed(magnitudes, self.dim // 2).to(self.dtype)
        return self.mlp(torch.cat([angle_emb, mag_emb], dim=-1))


class ButtonEmbedding(nn.Module):
    """Buttons [b, n, n_buttons] in {0, 1} -> [b, n, dim_out]."""

    def __init__(self, n_buttons: int, dim_out: int, dim: int = 512,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.proj = MLPCustom(n_buttons, 4 * dim, dim_out, dtype=dtype,
                              device=device)

    def forward(self, x):
        return self.proj(x.to(self.dtype) * 2.0 - 1.0)


class ControlEmbedding(nn.Module):
    """mouse + button."""

    def __init__(self, n_buttons: int, dim_out: int, dim: int = 512,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.mouse = MouseEmbedding(dim_out, dim, dtype=dtype, device=device)
        self.button = ButtonEmbedding(n_buttons, dim_out, dim, dtype=dtype,
                                      device=device)

    def forward(self, mouse, button):
        return self.mouse(mouse) + self.button(button)
