"""Condition embeddings (counterpart of owl_audio_exps_tpu/nn/embeddings.py).

* ``sincos_embed``: theta 300, mult 1000, [sin | cos] halves, float32;
* ``MouseEmbedding``: symlog deltas -> polar; the angle through a bias-free
  projection of [cos, sin], the magnitude through sincos;
* ``ButtonEmbedding``: {0, 1} -> {-1, 1} -> MLP;
* ``ControlEmbedding``: the sum of the two;
* ``StepEmbedding`` (a distilled student's step count, log2-scaled),
  ``ConditionEmbedding`` (a class id) and ``LearnedPosEnc`` (a learned
  additive position table, aligned to the end of a shorter input), which
  no model of either package builds.

The Linears are drawn by nn/layers.py ``reset_parameters``; the modules
with other parameters draw them in their own ``reset_parameters``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .layers import Linear, MLPCustom, reset_parameters


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


class StepEmbedding(nn.Module):
    """Steps (a scalar or [b]) -> [b, dim_out]: sincos(d_in) of
    log2(max_steps) - log2(steps) at mult 1000 / log2(max_steps), then an
    MLP(d_in, 4 dim_out, dim_out)."""

    def __init__(self, dim_out: int, d_in: int = 512, max_steps: int = 128,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.d_in = d_in
        self.max_steps = max_steps
        self.dtype = dtype
        self.mlp = MLPCustom(d_in, 4 * dim_out, dim_out, dtype=dtype,
                             device=device)

    def forward(self, steps):
        steps = torch.as_tensor(steps, dtype=torch.float32,
                                device=self.mlp.fc1.weight.device)
        if steps.ndim == 0:
            steps = steps[None]
        t = math.log2(self.max_steps) - torch.log2(steps)
        mult = 1000.0 / math.log2(self.max_steps)
        emb = sincos_embed(t, self.d_in, theta=300.0, mult=mult)
        return self.mlp(emb.to(self.dtype))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        reset_parameters(self, generator)


class ConditionEmbedding(nn.Module):
    """Class ids [...] -> [..., dim]: a float32 table, then an MLP(dim,
    4 dim, dim)."""

    def __init__(self, n_classes: int, dim: int, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Embedding(
            n_classes, dim, _weight=torch.zeros(n_classes, dim,
                                                device=device))
        self.mlp = MLPCustom(dim, 4 * dim, dim, dtype=dtype, device=device)

    def forward(self, x):
        return self.mlp(self.embedding(x).to(self.dtype))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        self.embedding.weight.normal_(
            0.0, self.embedding.embedding_dim ** -0.5, generator=generator)
        reset_parameters(self.mlp, generator)


class LearnedPosEnc(nn.Module):
    """x [b, n, dim] plus the last n rows of a learned [n_seq, dim] table
    (float32, drawn 0.02 N(0, 1)) in ``dtype``."""

    def __init__(self, n_seq: int, dim: int, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.n_seq = n_seq
        self.dtype = dtype
        self.p = nn.Parameter(torch.zeros(n_seq, dim, device=device))

    def forward(self, x):
        n = x.shape[1]
        p = self.p[-n:] if n < self.n_seq else self.p
        return x + p.to(self.dtype)[None]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        self.p.normal_(0.0, 0.02, generator=generator)


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
