"""Causal frame-window band attention over a sub-window chunk plan, forward
and backward (counterpart of owl_audio_exps_tpu/ops/band2.py
``band2_attention``, K5).

The function is the band's (ops/band.py): query frame f sees key frames
f - window + 1 .. f, no documents, with the fixed-shift softmax
exp(min(s - bound, 0)) / sum (its clamp's gradient passed straight
through) or, with ``logit_bound=None``, the usual softmax. What the TPU
kernel adds is a plan (S, m): the sequence is cut into chunks of S tokens,
query chunk i reads kv chunks i - m .. i and, when S is not a multiple of
tpf, the first ``_next_cols(S, tpf)`` tokens of chunk i + 1 (the NEXT ref
that holds the tail of a frame straddling the chunk boundary). Chunks
before the first and the NEXT ref of the last chunk are gated out. A
legal plan (``check_plan``: m * S >= C - 1, the JAX assertion) holds
every visible pair, so the plan changes the work and never the function.

On a CUDA tensor ``band2_attention`` launches the band's hand-written
kernels through the plan-checking entry points ``owl_band2_attn_*`` of
``csrc/band_attention.cu``: the forward, counted in ``fwd_launches``,
which also writes the f32 logsumexp, and one backward call that writes
dq, dk and dv (a dq kernel that also stores delta = rowsum(dO * O), then
a dkv kernel that reads it), counted once in ``bwd_launches``
(``Band2AttentionFunction`` joins them). On the H100 the plan is validated
(``check_plan``, and again by the entry points) but no longer shapes the
work: the kernels are the band's, on the wgmma + TMA bodies of
csrc/hopper_attention.cuh (the forward on a persistent grid). A block
works on 128-row tiles of the sequence and walks the closed-form window
range of the other operand (``kv_range`` / ``q_range`` there): the tiles
that hold a visible pair, which a legal plan's chunks always contain.
Each (query tile, key tile) pair is classified from global token
indices: FULL tiles run unmasked, the diagonal and window-edge tiles are
masked per element. The kernels read q, k, v, out and dout through TMA
tensor maps, in place: a view TMA cannot take raises ValueError. On a
CPU tensor ``band2_attention`` runs ``band2_attention_plain``, and
autograd over it is the plain backward. There is no other route.

``best_plan`` is the JAX package's auto policy with ``OWL_BAND2`` unset:
that variable is a TPU tuning hook and is left out, as the port leaves
out ``OWL_BAND_FW``. The router (nn/attn.py ``attention_route``) asks
for a plan only where ops/band.py ``band_available`` holds, as the JAX
package's does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _attn_launch as kl
from .band import band_attention_plain

# kernel launches since the last reset (set to 0 to reset)
fwd_launches = 0
bwd_launches = 0

_SOURCE = "band_attention"


# ------------------------------------------------------------------ plan

def _next_cols(S: int, tpf: int) -> int:
    """Columns of the NEXT ref a ragged span needs (0 for frame-aligned
    spans): the smallest divisor of S that is a multiple of 8 and at least
    min(tpf, S). -1 if no divisor works."""
    if S % tpf == 0:
        return 0
    need = min(tpf, S)
    for f in range(8, S + 1, 8):
        if S % f == 0 and f >= need:
            return f
    return -1


def plan_candidates(n_tokens: int, tokens_per_frame: int,
                    window: int) -> list:
    """All legal (span, m) plans for this geometry (for each m the
    smallest span), sorted by columns read per query row, (m + 1) * S
    plus the NEXT ref's.

    Legal: m * S >= C - 1 (coverage), S % 8 == 0, S >= 128, S >= tpf,
    S < C, S | L, L / S >= m + 1, and a ragged span admits a NEXT ref."""
    C = window * tokens_per_frame
    out = []
    for m in range(2, 9):
        smin = max(128, tokens_per_frame, -(-(C - 1) // m))
        for S in range((smin + 7) // 8 * 8, C, 8):
            if (n_tokens % S == 0 and n_tokens // S >= m + 1
                    and _next_cols(S, tokens_per_frame) >= 0):
                out.append((S, m))
                break
    out.sort(key=lambda sm:
             (sm[1] + 1) * sm[0] + _next_cols(sm[0], tokens_per_frame))
    return out


def best_plan(n_tokens: int, tokens_per_frame: int,
              window: int) -> Optional[Tuple[int, int]]:
    """The (span, m) the JAX package's router takes, or None: the first
    candidate whose span is frame-aligned and at least 256 tokens."""
    cands = [(S, m) for S, m in
             plan_candidates(n_tokens, tokens_per_frame, window)
             if S % tokens_per_frame == 0 and S >= 256]
    return cands[0] if cands else None


def check_plan(n_tokens: int, tokens_per_frame: int, window: int,
               span: int, nrefs: int):
    """The JAX package's assertion on a plan (ops/band2.py:623-626), and a
    NEXT ref for a ragged span; raises ValueError."""
    C = window * tokens_per_frame
    if not (nrefs * span >= C - 1 and n_tokens % span == 0
            and n_tokens // span >= nrefs + 1 and span % 8 == 0
            and span >= tokens_per_frame
            and _next_cols(span, tokens_per_frame) >= 0):
        raise ValueError(
            f"band2: (span {span}, refs {nrefs}) is no legal plan for "
            f"L={n_tokens}, tpf={tokens_per_frame}, window={window} "
            f"(C={C})")


# ---------------------------------------------------------------- plain

def band2_attention_plain(q, k, v, tokens_per_frame: int, window: int,
                          logit_bound: Optional[float] = None):
    """Dense reference of the kernel (the band's, ops/band.py): the plan
    does not change the function. Logits and softmax in float32,
    probabilities rounded to v's dtype for PV, q pre-scaled by Dh^-0.5 in
    q's dtype."""
    return band_attention_plain(q, k, v, tokens_per_frame, window,
                                logit_bound)


# ----------------------------------------------------------------- CUDA

def _ints(q, tokens_per_frame, window, span, nrefs):
    B, H, L, Dh = q.shape
    return (B, H, L, Dh, tokens_per_frame, window, 1, span, nrefs,
            _next_cols(span, tokens_per_frame))


def _floats(Dh, logit_bound):
    cap = float("inf") if logit_bound is None else float(logit_bound)
    return (Dh ** -0.5, cap)


def band2_attention_cuda(q, k, v, tokens_per_frame: int, window: int,
                         span: int, nrefs: int,
                         logit_bound: Optional[float] = None):
    """Launch the forward kernel on bf16 [B, H, L, Dh] CUDA tensors.
    Returns (out, lse): the bf16 output and the f32 logsumexp [B, H, L]
    the backward reads."""
    global fwd_launches
    kl.check_operands(q, q=q, k=k, v=v)
    kl.refuse_autograd(q, k, v)
    check_plan(q.shape[2], tokens_per_frame, window, span, nrefs)
    q, k, v = kl.tma_views(q=q, k=k, v=v)
    out = kl.empty_heads(q)
    B, H, L, Dh = q.shape
    lse = torch.empty(B, H, L, dtype=torch.float32, device=q.device)
    kl.launch(kl.entry(_SOURCE, "owl_band2_attn_fwd", 2),
              dict(q=q, k=k, v=v, o=out),
              _ints(q, tokens_per_frame, window, span, nrefs),
              _floats(Dh, logit_bound), lse=lse, what="band2 attention")
    fwd_launches += 1
    return out, lse


def band2_attention_bwd_cuda(q, k, v, out, lse, dout, tokens_per_frame: int,
                             window: int, span: int, nrefs: int,
                             logit_bound: Optional[float] = None):
    """Launch the backward (its dq kernel, which stores delta =
    rowsum(dO * O), then its dkv kernel). Returns (dq, dk, dv), bf16."""
    global bwd_launches
    kl.check_operands(q, q=q, k=k, v=v, out=out, dout=dout)
    check_plan(q.shape[2], tokens_per_frame, window, span, nrefs)
    q, k, v, out, dout = kl.tma_views(q=q, k=k, v=v, out=out, dout=dout)
    lse = lse.to(torch.float32).contiguous()
    dq, dk, dv = (kl.empty_heads(q) for _ in range(3))
    kl.launch(kl.entry(_SOURCE, "owl_band2_attn_bwd", 2),
              dict(q=q, k=k, v=v, o=out, dout=dout, dq=dq, dk=dk, dv=dv),
              _ints(q, tokens_per_frame, window, span, nrefs),
              _floats(q.shape[-1], logit_bound), lse=lse,
              delta=torch.empty_like(lse), what="band2 attention backward")
    bwd_launches += 1
    return dq, dk, dv


class Band2AttentionFunction(torch.autograd.Function):
    """Forward kernel (saving the logsumexp) with the backward kernels.
    Under ``torch.utils.checkpoint`` the recomputed forward is a forward
    launch like any other and is counted in ``fwd_launches``."""

    @staticmethod
    def forward(ctx, q, k, v, tokens_per_frame, window, span, nrefs,
                logit_bound):
        out, lse = band2_attention_cuda(q, k, v, tokens_per_frame, window,
                                        span, nrefs, logit_bound)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (tokens_per_frame, window, span, nrefs, logit_bound)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = band2_attention_bwd_cuda(
            q, k, v, out, lse, kl.dense_cotangent(dout), *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def band2_attention(q, k, v, tokens_per_frame: int, window: int, span: int,
                    nrefs: int, head_chunks: int = 1,
                    logit_bound: Optional[float] = None):
    """q, k, v: [B, H, L, Dh]; (span, nrefs) a legal plan (``check_plan``,
    e.g. from ``best_plan``). ``head_chunks`` > 1 splits the heads into
    that many calls (the TPU package's memory lever; same result).
    Returns [B, H, L, Dh] in q's dtype."""
    B, H, L, Dh = q.shape
    check_plan(L, tokens_per_frame, window, span, nrefs)
    if head_chunks > 1 and H % head_chunks == 0 and H > head_chunks:
        hc = H // head_chunks
        return torch.cat([
            band2_attention(q[:, c * hc:(c + 1) * hc],
                            k[:, c * hc:(c + 1) * hc],
                            v[:, c * hc:(c + 1) * hc],
                            tokens_per_frame, window, span, nrefs, 1,
                            logit_bound)
            for c in range(head_chunks)], dim=1)
    if q.device.type == "cpu":
        return band2_attention_plain(q, k, v, tokens_per_frame, window,
                                     logit_bound)
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            return Band2AttentionFunction.apply(
                q, k, v, tokens_per_frame, window, span, nrefs, logit_bound)
        return band2_attention_cuda(q, k, v, tokens_per_frame, window, span,
                                    nrefs, logit_bound)[0]
    raise NotImplementedError(f"no band2 attention for device {q.device}")
