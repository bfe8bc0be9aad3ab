"""Causal frame-window band attention, forward and backward (counterpart
of owl_audio_exps_tpu/ops/band.py ``band_attention``, K2 and K3).

Query frame f sees key frames f - window + 1 .. f; there are no
documents. The span C = window * tpf must divide L (``band_available``,
the TPU kernel's contract, kept as is). With ``logit_bound`` the softmax
is the TPU default's fixed shift, p = exp(min(s - bound, 0)) / sum, exact
when every logit is at most the bound (QK rms-norm bounds them by
sqrt(Dh)); its clamp is part of the function, and its gradient passes
straight through, as the TPU kernel's backward treats it. Without it the
softmax is the usual one.

On a CUDA tensor ``band_attention`` launches the hand-written kernels of
``csrc/band_attention.cu`` (the wgmma + TMA bodies of
csrc/hopper_attention.cuh; the forward on a persistent grid, a block per
SM): the forward, counted in ``fwd_launches``, and one backward call that
writes dq, dk and dv (a dq kernel that also stores delta = rowsum(dO *
O), then a dkv kernel that reads it), counted once in ``bwd_launches``
(``BandAttentionFunction`` joins them). The kernels read q, k, v, out
and dout through TMA tensor maps, in place: a view TMA cannot take
raises ValueError. On a CPU tensor
it runs ``band_attention_plain``, and autograd over it is the plain
backward. There is no other route.

The TPU package chooses between two kernel bodies by span alignment (K2,
frame-exact, for C % 128 == 0 and tpf % 8 == 0; K3, v1, for ragged spans
such as tpf 65): the same function, so one Hopper kernel pair serves both.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _attn_launch as kl
from .attention import NEG_INF
from .masks import dense_mask

# kernel launches since the last reset (set to 0 to reset)
fwd_launches = 0
bwd_launches = 0

_SOURCE = "band_attention"


def band_available(n_tokens: int, tokens_per_frame: int,
                   window: Optional[int], causal: bool) -> bool:
    """Kernel preconditions: causal frame window whose span C divides the
    sequence, C a multiple of 8 and at least 128, >= 2 chunks."""
    if window is None or not causal:
        return False
    C = window * tokens_per_frame
    return (n_tokens % C == 0 and n_tokens >= 2 * C
            and C % 8 == 0 and C >= 128)


def use_frame_exact(C: int, tokens_per_frame: int) -> bool:
    """The JAX package's choice of K2's frame-exact bodies for a span C
    (owl_audio_exps_tpu/ops/band.py ``_use_frame_exact`` with
    ``OWL_BAND_FW`` unset, a TPU tuning hook the port leaves out): a
    lane-aligned span of a sublane-aligned tpf. Where it holds, the JAX
    router keeps the band and never asks for a band2 plan."""
    return C % 128 == 0 and tokens_per_frame % 8 == 0


def band_attention_plain(q, k, v, tokens_per_frame: int, window: int,
                         logit_bound: Optional[float] = None):
    """Dense reference of the kernel in the inputs' dtype (float32 for
    float32 inputs): logits and softmax in float32, probabilities rounded
    to v's dtype for PV, q pre-scaled by Dh^-0.5 in q's dtype."""
    L, Dh = q.shape[2], q.shape[3]
    qs = (q * Dh ** -0.5).to(q.dtype)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    mask = dense_mask(L, tokens_per_frame, window, None, 0, True,
                      device=q.device)
    if logit_bound is None:
        probs = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
    else:
        bound = float(logit_bound)
        # min(s, bound), with the gradient of s passed straight through
        s_cap = s - (s - bound).clamp(min=0.0).detach()
        e = torch.where(mask, torch.exp(s_cap - bound), torch.zeros_like(s))
        probs = e / e.sum(dim=-1, keepdim=True)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _ints(q, tokens_per_frame, window):
    B, H, L, Dh = q.shape
    return (B, H, L, Dh, tokens_per_frame, window, 1)


def _floats(Dh, logit_bound):
    cap = float("inf") if logit_bound is None else float(logit_bound)
    return (Dh ** -0.5, cap)


def band_attention_cuda(q, k, v, tokens_per_frame: int, window: int,
                        logit_bound: Optional[float] = None):
    """Launch the forward kernel on bf16 [B, H, L, Dh] CUDA tensors.
    Returns (out, lse): the bf16 output and the f32 logsumexp [B, H, L]
    the backward reads."""
    global fwd_launches
    kl.check_operands(q, q=q, k=k, v=v)
    kl.refuse_autograd(q, k, v)
    L = q.shape[2]
    if not band_available(L, tokens_per_frame, window, True):
        raise ValueError(f"band kernel: no band of {window} frames x "
                         f"{tokens_per_frame} tokens divides L = {L}")
    q, k, v = kl.tma_views(q=q, k=k, v=v)
    out = kl.empty_heads(q)
    B, H, L, Dh = q.shape
    lse = torch.empty(B, H, L, dtype=torch.float32, device=q.device)
    kl.launch(kl.entry(_SOURCE, "owl_band_attn_fwd", 2),
              dict(q=q, k=k, v=v, o=out), _ints(q, tokens_per_frame, window),
              _floats(Dh, logit_bound), lse=lse, what="band attention")
    fwd_launches += 1
    return out, lse


def band_attention_bwd_cuda(q, k, v, out, lse, dout, tokens_per_frame: int,
                            window: int, logit_bound: Optional[float] = None):
    """Launch the backward (its dq kernel, which stores delta =
    rowsum(dO * O), then its dkv kernel). Returns (dq, dk, dv), bf16."""
    global bwd_launches
    kl.check_operands(q, q=q, k=k, v=v, out=out, dout=dout)
    q, k, v, out, dout = kl.tma_views(q=q, k=k, v=v, out=out, dout=dout)
    lse = lse.to(torch.float32).contiguous()
    dq, dk, dv = (kl.empty_heads(q) for _ in range(3))
    kl.launch(kl.entry(_SOURCE, "owl_band_attn_bwd", 2),
              dict(q=q, k=k, v=v, o=out, dout=dout, dq=dq, dk=dk, dv=dv),
              _ints(q, tokens_per_frame, window),
              _floats(q.shape[-1], logit_bound), lse=lse,
              delta=torch.empty_like(lse), what="band attention backward")
    bwd_launches += 1
    return dq, dk, dv


class BandAttentionFunction(torch.autograd.Function):
    """Forward kernel (saving the logsumexp) with the backward kernels.
    Under ``torch.utils.checkpoint`` the recomputed forward is a forward
    launch like any other and is counted in ``fwd_launches``."""

    @staticmethod
    def forward(ctx, q, k, v, tokens_per_frame, window, logit_bound):
        out, lse = band_attention_cuda(q, k, v, tokens_per_frame, window,
                                       logit_bound)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (tokens_per_frame, window, logit_bound)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = band_attention_bwd_cuda(
            q, k, v, out, lse, kl.dense_cotangent(dout), *ctx.args)
        return dq, dk, dv, None, None, None


def band_attention(q, k, v, tokens_per_frame: int, window: int,
                   head_chunks: int = 1,
                   logit_bound: Optional[float] = None):
    """q, k, v: [B, H, L, Dh] with ``band_available(L, tpf, window,
    True)``. ``head_chunks`` > 1 splits the heads into that many calls
    (the TPU package's memory lever; same result). Returns [B, H, L, Dh]
    in q's dtype."""
    B, H, L, Dh = q.shape
    if not band_available(L, tokens_per_frame, window, True):
        raise ValueError(f"band attention needs a causal window whose span "
                         f"divides L (L={L}, tpf={tokens_per_frame}, "
                         f"window={window})")
    if head_chunks > 1 and H % head_chunks == 0 and H > head_chunks:
        hc = H // head_chunks
        return torch.cat([
            band_attention(q[:, c * hc:(c + 1) * hc],
                           k[:, c * hc:(c + 1) * hc],
                           v[:, c * hc:(c + 1) * hc],
                           tokens_per_frame, window, 1, logit_bound)
            for c in range(head_chunks)], dim=1)
    if q.device.type == "cpu":
        return band_attention_plain(q, k, v, tokens_per_frame, window,
                                    logit_bound)
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            return BandAttentionFunction.apply(q, k, v, tokens_per_frame,
                                               window, logit_bound)
        return band_attention_cuda(q, k, v, tokens_per_frame, window,
                                   logit_bound)[0]
    raise NotImplementedError(f"no band attention for device {q.device}")
