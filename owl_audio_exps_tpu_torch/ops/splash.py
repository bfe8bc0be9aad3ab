"""Frame-mask flash attention, forward and backward (counterpart of
owl_audio_exps_tpu/ops/splash.py ``splash_attention`` and its custom vjp),
and the ring partial of context parallelism (``splash_attention_lse`` and
``splash_attention_lse_vjp``, K4).

On a CUDA tensor ``splash_attention`` launches the hand-written Hopper
kernels of ``csrc/frame_attention.cu`` (built with nvcc at first use,
bound with ctypes): the forward, counted in ``launches``, and, when
autograd needs gradients, the dq and dkv kernels, counted in
``dq_launches`` and ``dkv_launches``. ``FrameAttentionFunction`` is the
``torch.autograd.Function`` that joins them; its forward also saves the
f32 logsumexp the backward reads (the serve path, which needs no
gradient, does not ask for it). On a CPU tensor ``splash_attention``
runs ``splash_attention_plain``, the dense mask + ``dot_attention``
version of the same function, and autograd over it is the plain
backward. There is no other route: a CUDA call either launches the
kernels or raises. The kernels' bodies (csrc/hopper_attention.cuh) read
q, k, v, out and dout through TMA tensor maps, in place: a view TMA
cannot take raises ValueError (``_attn_launch.tma_geometry``), and only
an output cotangent autograd hands in (the expanded gradient of
``out.sum()``, say) is made dense first.

Visibility is the TPU package's ``FrameMask`` algebra, ANDed with
same-document equality when ``doc_id`` is given. With documents the
kernels walk a summary of the ids (``ops/doc_tiles.py``), written on the
card by a helper kernel once a forward call (counted in
``doc_tiles.launches``) and kept for its backward: ``doc_tiles_for``
makes a ``DocTiles`` of it, which every entry point here also takes in
place of ``doc_id``. q is pre-scaled by
``scale`` (default Dh^-0.5) in q's dtype, as on the TPU, so
dq = scale * d(scaled q). The kernels mask ragged lengths themselves, so
nothing is padded (the TPU's sentinel-segment padding only existed for
its block legality).

K4. ``splash_attention_lse`` returns ``(out, lse)``, both float32, of
already-scaled q (no internal scaling) under the frame-causal mask or no
mask, and takes cotangents on both outputs. On a CUDA tensor it launches
the ring entry points of the same source (counted in ``lse_launches``,
``lse_dq_launches``, ``lse_dkv_launches``, apart from K1's counts):
the forward writes bf16 out and the f32 logsumexp (out is then cast to
f32, as the TPU kernel's output is), and ``SplashLseFunction``'s
backward (``splash_attention_lse_vjp``) is one dq + dkv pass: the lse
cotangent folds into delta' = rowsum(out * g_out) - g_lse, computed in
f32 from the f32 cotangent as the JAX package computes di', which both
kernels read. On a CPU tensor it runs ``splash_attention_lse_plain``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import _attn_launch as kl
from . import doc_tiles as dt
from .attention import dot_attention
from .masks import dense_mask

# kernel launches since the last reset (set to 0 to reset)
launches = 0       # forward
dq_launches = 0    # backward, dq kernel
dkv_launches = 0   # backward, dkv kernel
lse_launches = 0       # K4 forward (ring partial)
lse_dq_launches = 0    # K4 backward, dq kernel
lse_dkv_launches = 0   # K4 backward, dkv kernel

_SOURCE = "frame_attention"


def splash_attention_plain(q, k, v, tokens_per_frame: int,
                           window: Optional[int], causal: bool,
                           doc_id=None, scale: Optional[float] = None):
    """Dense reference of the kernel: materialized mask + dot_attention.
    Computes in the inputs' dtype (float32 for float32 inputs)."""
    L, Dh = q.shape[2], q.shape[3]
    if scale is None:
        scale = Dh ** -0.5
    if isinstance(doc_id, DocTiles):
        doc_id = doc_id.doc
    qs = (q * scale).to(q.dtype)
    mask = dense_mask(L, tokens_per_frame, window,
                      None if doc_id is None else doc_id.long(), 0,
                      causal, device=q.device)
    return dot_attention(qs, k, v, mask, scale=1.0)


def _ints(q, tokens_per_frame, window, causal):
    B, H, L, Dh = q.shape
    return (B, H, L, Dh, tokens_per_frame, window or 0, int(bool(causal)))


class DocTiles(NamedTuple):
    """A per-frame doc_id on the card with the summary K1's kernels walk
    (ops/doc_tiles.py), made for one mask."""
    doc: torch.Tensor        # int32 [B, n_frames]
    summary: torch.Tensor    # int32 [B, doc_tiles_row(L, tpf)]
    mask: tuple              # (L, tpf, window or 0, causal)


def doc_tiles_for(doc_id, q, tokens_per_frame: int, window: Optional[int],
                  causal: bool) -> Optional[DocTiles]:
    """``doc_id`` (per-frame [B, n_frames]) on q's card with its summary,
    written there by the helper kernel (no host read of the ids); a
    DocTiles made for this mask as it is; None for None."""
    if doc_id is None:
        return None
    B, L = q.shape[0], q.shape[2]
    mask = (L, tokens_per_frame, window or 0, bool(causal))
    if isinstance(doc_id, DocTiles):
        if doc_id.mask != mask or doc_id.doc.shape[0] != B:
            raise ValueError(f"DocTiles made for {doc_id.mask}, used at "
                             f"{mask} with batch {B}")
        return doc_id
    n_frames = -(-L // tokens_per_frame)
    if tuple(doc_id.shape) != (B, n_frames):
        raise ValueError(f"doc_id shape {tuple(doc_id.shape)} != "
                         f"{(B, n_frames)}")
    doc = doc_id.to(device=q.device, dtype=torch.int32).contiguous()
    return DocTiles(doc, dt.doc_tiles_cuda(doc, L, tokens_per_frame, window,
                                           causal), mask)


def _doc_args(docs: Optional[DocTiles]) -> dict:
    return {} if docs is None else dict(doc=docs.doc,
                                        doc_summary=docs.summary)


def frame_attention_cuda(q, k, v, tokens_per_frame: int,
                         window: Optional[int], causal: bool,
                         doc_id=None, scale: Optional[float] = None,
                         return_lse: bool = False):
    """Launch the forward kernel. q, k, v: [B, H, L, Dh] bf16 on one card,
    Dh 64 or 128; doc_id: per-frame [B, n_frames], its DocTiles, or None.
    With ``return_lse`` also returns the f32 logsumexp [B, H, L] of the
    scaled logits."""
    global launches
    kl.check_operands(q, q=q, k=k, v=v)
    kl.refuse_autograd(q, k, v)
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive or None, got {window}")
    docs = doc_tiles_for(doc_id, q, tokens_per_frame, window, causal)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    q, k, v = kl.tma_views(q=q, k=k, v=v)
    out = kl.empty_heads(q)
    B, H, L, _ = q.shape
    lse = (torch.empty(B, H, L, dtype=torch.float32, device=q.device)
           if return_lse else None)
    kl.launch(kl.entry(_SOURCE, "owl_frame_attn_fwd", 1),
              dict(q=q, k=k, v=v, o=out),
              _ints(q, tokens_per_frame, window, causal), (float(scale),),
              lse=lse, what="frame attention", **_doc_args(docs))
    launches += 1
    return (out, lse) if return_lse else out


def _bwd_args(q, k, v, out, dout, tokens_per_frame, window, causal, doc_id,
              scale):
    kl.check_operands(q, q=q, k=k, v=v, out=out, dout=dout)
    docs = doc_tiles_for(doc_id, q, tokens_per_frame, window, causal)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    q, k, v, out, dout = kl.tma_views(q=q, k=k, v=v, out=out, dout=dout)
    return dict(q=q, k=k, v=v, o=out, dout=dout), docs, float(scale)


def frame_attention_bwd_dq_cuda(q, k, v, out, lse, dout,
                                tokens_per_frame: int, window: Optional[int],
                                causal: bool, doc_id=None,
                                scale: Optional[float] = None):
    """Launch the dq kernel. Returns (dq, delta): bf16 [B, H, L, Dh] and
    the f32 [B, H, L] rowsum(dO * O) the dkv kernel reads."""
    global dq_launches
    args, docs, scale = _bwd_args(q, k, v, out, dout, tokens_per_frame,
                                  window, causal, doc_id, scale)
    lse = lse.to(torch.float32).contiguous()
    delta = torch.empty_like(lse)
    args["dq"] = kl.empty_heads(args["q"])
    kl.launch(kl.entry(_SOURCE, "owl_frame_attn_bwd_dq", 1), args,
              _ints(q, tokens_per_frame, window, causal), (scale,), lse=lse,
              delta=delta, what="frame attention dq", **_doc_args(docs))
    dq_launches += 1
    return args["dq"], delta


def frame_attention_bwd_dkv_cuda(q, k, v, out, lse, delta, dout,
                                 tokens_per_frame: int,
                                 window: Optional[int], causal: bool,
                                 doc_id=None, scale: Optional[float] = None):
    """Launch the dkv kernel (after the dq kernel, whose delta it reads).
    Returns (dk, dv), bf16 [B, H, L, Dh]."""
    global dkv_launches
    args, docs, scale = _bwd_args(q, k, v, out, dout, tokens_per_frame,
                                  window, causal, doc_id, scale)
    args["dk"], args["dv"] = (kl.empty_heads(args["q"]) for _ in range(2))
    kl.launch(kl.entry(_SOURCE, "owl_frame_attn_bwd_dkv", 1), args,
              _ints(q, tokens_per_frame, window, causal), (scale,),
              lse=lse.to(torch.float32).contiguous(), delta=delta,
              what="frame attention dkv", **_doc_args(docs))
    dkv_launches += 1
    return args["dk"], args["dv"]


def frame_attention_bwd_cuda(q, k, v, out, lse, dout, tokens_per_frame: int,
                             window: Optional[int], causal: bool,
                             doc_id=None, scale: Optional[float] = None):
    """The dq kernel (which also stores delta = rowsum(dO * O)), then the
    dkv kernel, on one summary of the documents. Returns (dq, dk, dv), bf16
    [B, H, L, Dh]."""
    doc_id = doc_tiles_for(doc_id, q, tokens_per_frame, window, causal)
    mask = (tokens_per_frame, window, causal, doc_id, scale)
    dq, delta = frame_attention_bwd_dq_cuda(q, k, v, out, lse, dout, *mask)
    dk, dv = frame_attention_bwd_dkv_cuda(q, k, v, out, lse, delta, dout,
                                          *mask)
    return dq, dk, dv


class FrameAttentionFunction(torch.autograd.Function):
    """Forward kernel (saving the logsumexp) with the dq + dkv kernels as
    its backward, all three on one summary of the documents. Under
    ``torch.utils.checkpoint`` the recomputed forward is a forward launch
    like any other and is counted in ``launches``."""

    @staticmethod
    def forward(ctx, q, k, v, tokens_per_frame, window, causal, doc_id,
                scale):
        docs = doc_tiles_for(doc_id, q, tokens_per_frame, window, causal)
        out, lse = frame_attention_cuda(q, k, v, tokens_per_frame, window,
                                        causal, docs, scale,
                                        return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (tokens_per_frame, window, causal, docs, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = frame_attention_bwd_cuda(
            q, k, v, out, lse, kl.dense_cotangent(dout), *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def splash_attention(q, k, v, tokens_per_frame: int, window: Optional[int],
                     causal: bool, doc_id=None, head_chunks: int = 1,
                     scale: Optional[float] = None):
    """q, k, v: [B, H, L, Dh]; doc_id: per-frame [B, n_frames] (or, on
    the card, its DocTiles) or None. ``head_chunks`` > 1 splits the heads
    into that many calls (a memory lever carried over from the TPU package;
    same result). Returns [B, H, L, Dh] in q's dtype."""
    H = q.shape[1]
    if q.device.type == "cuda":   # one summary for every head chunk
        doc_id = doc_tiles_for(doc_id, q, tokens_per_frame, window, causal)
    if head_chunks > 1 and H % head_chunks == 0 and H > head_chunks:
        hc = H // head_chunks
        return torch.cat([
            splash_attention(q[:, i * hc:(i + 1) * hc],
                             k[:, i * hc:(i + 1) * hc],
                             v[:, i * hc:(i + 1) * hc],
                             tokens_per_frame, window, causal, doc_id,
                             scale=scale)
            for i in range(head_chunks)], dim=1)
    if q.device.type == "cpu":
        return splash_attention_plain(q, k, v, tokens_per_frame, window,
                                      causal, doc_id, scale)
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            return FrameAttentionFunction.apply(
                q, k, v, tokens_per_frame, window, causal, doc_id, scale)
        return frame_attention_cuda(q, k, v, tokens_per_frame, window,
                                    causal, doc_id, scale)
    raise NotImplementedError(f"no frame attention for device {q.device}")


# ------------------------------------------------------------------ K4

def splash_attention_lse_plain(q, k, v, tokens_per_frame: int, causal: bool):
    """Dense reference of K4: (out, lse) of pre-scaled q over k, v with
    the frame-causal mask (``causal``) or none. Logits and logsumexp in
    float32, probabilities rounded to v's dtype before PV (as the JAX
    package's dense ring partial does); both results float32."""
    L = q.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if causal:
        mask = dense_mask(L, tokens_per_frame, None, None, 0, True,
                          device=q.device)
        s = s.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    probs = torch.exp(s - lse[..., None]).to(v.dtype)
    out = torch.matmul(probs.float(), v.float())
    return out, lse


def splash_attention_lse_vjp_plain(q, k, v, out, lse, g_out, g_lse,
                                   tokens_per_frame: int, causal: bool):
    """(dq, dk, dv) of the plain K4 for cotangents on both outputs, by
    autograd (``out`` and ``lse`` are recomputed; they are taken for the
    signature of the kernel's vjp)."""
    del out, lse
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o, l = splash_attention_lse_plain(*leaves, tokens_per_frame, causal)
        g_lse = torch.zeros_like(l) if g_lse is None else g_lse.to(l.dtype)
        grads = torch.autograd.grad((o, l), leaves, (g_out.to(o.dtype), g_lse))
    return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v)))


def _ring_ints(q, tokens_per_frame, causal):
    B, H, L, Dh = q.shape
    return (B, H, L, Dh, tokens_per_frame, 0, int(bool(causal)))


def splash_attention_lse_cuda(q, k, v, tokens_per_frame: int, causal: bool):
    """Launch the K4 forward on bf16 [B, H, L, Dh] CUDA tensors (q
    pre-scaled). Returns (out bf16, lse f32 [B, H, L])."""
    global lse_launches
    kl.check_operands(q, q=q, k=k, v=v)
    kl.refuse_autograd(q, k, v)
    q, k, v = kl.tma_views(q=q, k=k, v=v)
    out = kl.empty_heads(q)
    B, H, L, _ = q.shape
    lse = torch.empty(B, H, L, dtype=torch.float32, device=q.device)
    kl.launch(kl.entry(_SOURCE, "owl_ring_attn_fwd", 0),
              dict(q=q, k=k, v=v, o=out),
              _ring_ints(q, tokens_per_frame, causal), (), lse=lse,
              what="ring partial")
    lse_launches += 1
    return out, lse


def ring_delta(out, g_out, g_lse):
    """delta' = rowsum(out * g_out) - g_lse, float32 [B, H, L]: the K4
    backward's shifted delta, computed from the float32 cotangent as the
    JAX package computes di' outside its kernels. ``g_lse`` may be None."""
    delta = (out.float() * g_out.float()).sum(-1)
    return delta if g_lse is None else delta - g_lse.float()


def _lse_bwd_args(q, k, v, lse, delta, g_out, tokens_per_frame, causal):
    g_out = kl.dense_cotangent(g_out)
    kl.check_operands(q, q=q, k=k, v=v, dout=g_out)
    q, k, v, g_out = kl.tma_views(q=q, k=k, v=v, dout=g_out)
    lse, delta = (t.to(torch.float32).contiguous() for t in (lse, delta))
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != tuple(q.shape[:3]):
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{tuple(q.shape[:3])}")
    return (dict(q=q, k=k, v=v, dout=g_out), lse, delta,
            _ring_ints(q, tokens_per_frame, causal))


def splash_attention_lse_bwd_dq_cuda(q, k, v, lse, delta, g_out,
                                     tokens_per_frame: int, causal: bool):
    """Launch the K4 dq kernel on delta' (``ring_delta``); ``g_out`` is
    rounded to bf16 for the products. Returns dq, bf16."""
    global lse_dq_launches
    args, lse, delta, ints = _lse_bwd_args(q, k, v, lse, delta, g_out,
                                           tokens_per_frame, causal)
    args["dq"] = kl.empty_heads(args["q"])
    kl.launch(kl.entry(_SOURCE, "owl_ring_attn_bwd_dq", 0), args, ints, (),
              lse=lse, delta=delta, what="ring partial dq")
    lse_dq_launches += 1
    return args["dq"]


def splash_attention_lse_bwd_dkv_cuda(q, k, v, lse, delta, g_out,
                                      tokens_per_frame: int, causal: bool):
    """Launch the K4 dkv kernel on delta' (``ring_delta``). Returns
    (dk, dv), bf16."""
    global lse_dkv_launches
    args, lse, delta, ints = _lse_bwd_args(q, k, v, lse, delta, g_out,
                                           tokens_per_frame, causal)
    args["dk"], args["dv"] = (kl.empty_heads(args["q"]) for _ in range(2))
    kl.launch(kl.entry(_SOURCE, "owl_ring_attn_bwd_dkv", 0), args, ints, (),
              lse=lse, delta=delta, what="ring partial dkv")
    lse_dkv_launches += 1
    return args["dk"], args["dv"]


def splash_attention_lse_vjp_cuda(q, k, v, out, lse, g_out, g_lse,
                                  tokens_per_frame: int, causal: bool):
    """The K4 backward: delta' in float32, then the dq kernel and the dkv
    kernel. Returns (dq, dk, dv), bf16."""
    delta = ring_delta(out, g_out, g_lse)
    mask = (tokens_per_frame, causal)
    dq = splash_attention_lse_bwd_dq_cuda(q, k, v, lse, delta, g_out, *mask)
    dk, dv = splash_attention_lse_bwd_dkv_cuda(q, k, v, lse, delta, g_out,
                                               *mask)
    return dq, dk, dv


class SplashLseFunction(torch.autograd.Function):
    """K4 forward with the one-pass K4 backward, taking cotangents on out
    and lse. Under ``torch.utils.checkpoint`` the recomputed forward is
    counted in ``lse_launches`` like any other."""

    @staticmethod
    def forward(ctx, q, k, v, tokens_per_frame, causal):
        out, lse = splash_attention_lse_cuda(q, k, v, tokens_per_frame,
                                             causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (tokens_per_frame, causal)
        return out.float(), lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        dq, dk, dv = splash_attention_lse_vjp(q, k, v, out, lse, g_out,
                                              g_lse, *ctx.args)
        return dq, dk, dv, None, None


def splash_attention_lse(q, k, v, tokens_per_frame: int, causal: bool):
    """Ring partial (K4): q (pre-scaled), k, v [B, H, L, Dh] -> (out, lse),
    float32 [B, H, L, Dh] and [B, H, L]: the normalized softmax output of
    q's rows over these keys and their natural-log logsumexp, under the
    frame-causal mask (``causal``) or none. Differentiable in both
    outputs."""
    if q.device.type == "cpu":
        return splash_attention_lse_plain(q, k, v, tokens_per_frame, causal)
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            return SplashLseFunction.apply(q, k, v, tokens_per_frame, causal)
        out, lse = splash_attention_lse_cuda(q, k, v, tokens_per_frame,
                                             causal)
        return out.float(), lse
    raise NotImplementedError(f"no ring partial for device {q.device}")


def splash_attention_lse_vjp(q, k, v, out, lse, g_out, g_lse,
                             tokens_per_frame: int, causal: bool):
    """(dq, dk, dv) of ``splash_attention_lse`` for cotangents ``g_out``
    [B, H, L, Dh] and ``g_lse`` [B, H, L] (or None): one standard flash
    backward with delta' = rowsum(out * g_out) - g_lse. ``out`` and
    ``lse`` are the forward's; q is pre-scaled as at the forward. The
    backward of ``SplashLseFunction`` on CUDA tensors."""
    if q.device.type == "cpu":
        return splash_attention_lse_vjp_plain(q, k, v, out, lse, g_out,
                                              g_lse, tokens_per_frame, causal)
    if q.device.type == "cuda":
        return splash_attention_lse_vjp_cuda(q, k, v, out, lse, g_out, g_lse,
                                             tokens_per_frame, causal)
    raise NotImplementedError(f"no ring partial for device {q.device}")


def visible_pairs(L: int, tokens_per_frame: int, window: Optional[int],
                  causal: bool, doc_id=None) -> int:
    """Number of visible (query, key) pairs of one head, from the mask
    algebra in closed form per query frame (used to count the work a call
    needs). With ``doc_id`` [n_frames] (one batch row) the same-document
    rule applies too."""
    tpf = tokens_per_frame
    nf = -(-L // tpf)
    sizes = [min(tpf, L - f * tpf) for f in range(nf)]
    docs = None if doc_id is None else [int(d) for d in doc_id]
    total = 0
    for fq in range(nf):
        lo = 0 if window is None else max(0, fq - window + 1)
        hi = fq if causal else (nf - 1 if window is None
                                else min(nf - 1, fq + window - 1))
        seen = sum(sizes[fk] for fk in range(lo, hi + 1)
                   if docs is None or docs[fk] == docs[fq])
        total += sizes[fq] * seen
    return total
