"""Core layers (counterpart of owl_audio_exps_tpu/nn/layers.py).

Parameters are stored as ``nn.Parameter``s in the torch reference layout
(``weight`` [out, in]); every layer computes in its ``dtype``, casting
weights and inputs to it, as the JAX package does. ``reset_parameters``
draws the reference's initial distributions from an explicit generator:
torch's default ``nn.Linear`` init, U(±1/sqrt(fan_in)), or for the
MLPs' layers N(0, 2 / fan_in^2) with zero bias.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norms import rms_norm


class Linear(nn.Module):
    """x @ W^T + b in ``dtype``; ``init`` is "torch" or "scaled_kaiming"."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.bfloat16, init: str = "torch", device=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.dtype = dtype
        self.init = init
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               device=device))
        self.bias = (nn.Parameter(torch.empty(out_features, device=device))
                     if bias else None)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        fan_in = self.in_features
        if self.init == "scaled_kaiming":
            self.weight.normal_(0.0, (2.0 ** 0.5) / fan_in,
                                generator=generator)
            if self.bias is not None:
                self.bias.zero_()
            return
        bound = fan_in ** -0.5
        self.weight.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class MLPCustom(nn.Module):
    """fc1 -> SiLU -> fc2 with scaled-kaiming init."""

    def __init__(self, dim_in: int, dim_middle: int, dim_out: int,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        kw = dict(dtype=dtype, init="scaled_kaiming", device=device)
        self.fc1 = Linear(dim_in, dim_middle, **kw)
        self.fc2 = Linear(dim_middle, dim_out, **kw)

    def forward(self, x):
        return self.fc2(F.silu(self.fc1(x)))


class MLP(MLPCustom):
    """Transformer MLP: d -> 4d -> d, SiLU (params ``mlp.fc1``, ``mlp.fc2``)."""

    def __init__(self, d_model: int, dtype=torch.bfloat16, device=None):
        super().__init__(d_model, 4 * d_model, d_model, dtype=dtype,
                         device=device)


def broadcast_cond(cond: torch.Tensor, n_tokens: int) -> torch.Tensor:
    """Per-frame cond [b, n, d] -> per-token [b, n*m, d]."""
    b, n, d = cond.shape
    m = n_tokens // n
    return cond[:, :, None, :].expand(b, n, m, d).reshape(b, n_tokens, d)


def modulate_tokens(x_norm: torch.Tensor, a: torch.Tensor,
                    b_: torch.Tensor) -> torch.Tensor:
    """x_norm * (1 + a) + b with per-frame a, b broadcast to per-token."""
    b, nm, d = x_norm.shape
    n = a.shape[1]
    x4 = x_norm.reshape(b, n, nm // n, d)
    return (x4 * (1.0 + a[:, :, None, :]) + b_[:, :, None, :]).reshape(b, nm, d)


def gate_tokens(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """x * c with per-frame c broadcast to per-token."""
    b, nm, d = x.shape
    n = c.shape[1]
    return (x.reshape(b, n, nm // n, d) * c[:, :, None, :]).reshape(b, nm, d)


class AdaLN(nn.Module):
    """rms_norm(x) modulated by scale/bias from the per-frame cond."""

    def __init__(self, dim: int, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.fc = Linear(dim, 2 * dim, dtype=dtype, device=device)

    def forward(self, x, cond):
        ab = self.fc(F.silu(cond.to(self.dtype)))
        a, b_ = ab.chunk(2, dim=-1)
        return modulate_tokens(rms_norm(x), a, b_)


class Gate(nn.Module):
    """Output gate from the per-frame cond."""

    def __init__(self, dim: int, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.fc_c = Linear(dim, dim, dtype=dtype, device=device)

    def forward(self, x, cond):
        return gate_tokens(x, self.fc_c(F.silu(cond.to(self.dtype))))


class FinalLayer(nn.Module):
    """AdaLN -> SiLU -> Linear projection head."""

    def __init__(self, d_model: int, channels: int, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.norm = AdaLN(d_model, dtype=dtype, device=device)
        self.proj = Linear(d_model, channels, dtype=dtype, device=device)

    def forward(self, x, cond):
        return self.proj(F.silu(self.norm(x, cond)))


def reset_parameters(module: nn.Module, generator: torch.Generator):
    """Draw every Linear's initial weights from ``generator``."""
    for m in module.modules():
        if isinstance(m, Linear):
            m.reset_parameters(generator)
