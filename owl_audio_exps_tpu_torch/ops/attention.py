"""Masked dense attention (counterpart of owl_audio_exps_tpu/ops/attention.py).

``dot_attention`` sets the numerics contract every attention path of the
port follows: logits and softmax in float32 from operands in the working
dtype, probabilities rounded to the value dtype, PV accumulated in
float32, output in q's dtype.
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
