"""Masked dense attention (counterpart of owl_audio_exps_tpu/ops/attention.py).

``dot_attention`` sets the numerics contract every attention path of the
port follows: logits and softmax in float32 from operands in the working
dtype, probabilities rounded to the value dtype, PV accumulated in
float32, output in q's dtype. ``cached_dot_attention`` keeps that
contract over two key sources, the ring cache and the new tokens, without
concatenating them.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = torch.finfo(torch.float32).min


def dot_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q, k, v: [b, h, l, dh]; mask bool broadcastable to [b, h, lq, lkv]
    ([lq, lkv] shared, or [b, lq, lkv] per batch row)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    # operands upcast exactly; the products accumulate in float32
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        if mask.ndim == 2:
            mask = mask[None, None]
        elif mask.ndim == 3:
            mask = mask[:, None]
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _norm_mask(mask: torch.Tensor) -> torch.Tensor:
    if mask.ndim == 2:
        return mask[None, None]
    if mask.ndim == 3:
        return mask[:, None]
    return mask


def cached_dot_attention(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    new_k: torch.Tensor,
    new_v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention over [ring cache | new tokens] without concatenating K/V:
    two QK^T products, one softmax over the concatenated float32 scores,
    two PV products summed in float32. q: [b, h, lq, dh]; cache_k/v: [b,
    h, S, dh]; new_k/v: [b, h, t, dh]; mask broadcastable to [b, h, lq, S
    + t], cache part first."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    S = cache_k.shape[2]
    qf = q.float()
    s1 = torch.matmul(qf, cache_k.float().transpose(-1, -2)) * scale
    s2 = torch.matmul(qf, new_k.float().transpose(-1, -2)) * scale
    if mask is not None:
        mask = _norm_mask(mask)
        s1 = s1.masked_fill(~mask[..., :S], NEG_INF)
        s2 = s2.masked_fill(~mask[..., S:], NEG_INF)
    probs = torch.softmax(torch.cat([s1, s2], dim=-1), dim=-1)
    p1 = probs[..., :S].to(cache_v.dtype).float()
    p2 = probs[..., S:].to(new_v.dtype).float()
    out = (torch.matmul(p1, cache_v.float())
           + torch.matmul(p2, new_v.float()))
    return out.to(q.dtype)
