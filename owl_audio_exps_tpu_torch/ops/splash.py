"""Frame-mask flash attention, forward (counterpart of
owl_audio_exps_tpu/ops/splash.py ``splash_attention``).

On a CUDA tensor ``splash_attention`` launches the hand-written Hopper
kernel ``csrc/frame_attention.cu`` (built with nvcc at first use, bound
with ctypes) and counts the launch in ``launches``. On a CPU tensor it
runs ``splash_attention_plain``, the dense mask + ``dot_attention``
version of the same function. There is no other route: a CUDA call
either launches the kernel or raises.

Visibility is the TPU package's ``FrameMask`` algebra, ANDed with
same-document equality when ``doc_id`` is given. q is pre-scaled by
``scale`` (default Dh^-0.5) in q's dtype, as on the TPU. The kernel masks
ragged lengths itself, so nothing is padded (the TPU's sentinel-segment
padding only existed for its block legality).

The kernel has no backward yet: a CUDA input that requires grad raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .attention import dot_attention
from .masks import dense_mask

launches = 0   # kernel launches since the last reset (set to 0 to reset)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of csrc/frame_attention.cu (built at first use)."""
    from . import _build
    fn = _build.load("frame_attention").owl_frame_attn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 12
                   + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def splash_attention_plain(q, k, v, tokens_per_frame: int,
                           window: Optional[int], causal: bool,
                           doc_id=None, scale: Optional[float] = None):
    """Dense reference of the kernel: materialized mask + dot_attention.
    Computes in the inputs' dtype (float32 for float32 inputs)."""
    L, Dh = q.shape[2], q.shape[3]
    if scale is None:
        scale = Dh ** -0.5
    qs = (q * scale).to(q.dtype)
    mask = dense_mask(L, tokens_per_frame, window,
                      None if doc_id is None else doc_id.long(), 0,
                      causal, device=q.device)
    return dot_attention(qs, k, v, mask, scale=1.0)


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """The kernel reads [B, H, L, Dh] through its strides with 16-byte
    loads: the last dim must be contiguous and every stride and the base
    16-byte aligned. The layouts Attn produces (a transposed view of the
    [B, L, H, Dh] projection) qualify; anything else is copied."""
    ok = (t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:3])
          and t.data_ptr() % 16 == 0)
    return t if ok else t.contiguous()


def frame_attention_cuda(q, k, v, tokens_per_frame: int,
                         window: Optional[int], causal: bool,
                         doc_id=None, scale: Optional[float] = None):
    """Launch the CUDA kernel. q, k, v: [B, H, L, Dh] bf16 on one card,
    Dh 64 or 128; doc_id: per-frame [B, n_frames] or None."""
    global launches
    B, H, L, Dh = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device")
        if t.dtype != torch.bfloat16:
            raise NotImplementedError(
                f"frame attention kernel takes bf16, got {name} {t.dtype}")
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q shape "
                             f"{tuple(q.shape)} (self-attention only)")
        if t.requires_grad:
            raise NotImplementedError(
                "frame attention kernel has no backward yet (the training "
                "slice brings it)")
    if Dh not in (64, 128):
        raise NotImplementedError(f"head dim {Dh}: the kernel takes 64 or 128")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive or None, got {window}")
    n_frames = -(-L // tokens_per_frame)
    doc = None
    if doc_id is not None:
        if tuple(doc_id.shape) != (B, n_frames):
            raise ValueError(f"doc_id shape {tuple(doc_id.shape)} != "
                             f"{(B, n_frames)}")
        doc = doc_id.to(device=q.device, dtype=torch.int32).contiguous()
    if scale is None:
        scale = Dh ** -0.5

    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    # [B, L, H, Dh] storage seen as [B, H, L, Dh]: the caller's transpose
    # back to tokens-major is then free
    out = torch.empty(B, L, H, Dh, dtype=q.dtype,
                      device=q.device).transpose(1, 2)

    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if doc is None else doc.data_ptr(), *strides,
        B, H, L, Dh, tokens_per_frame, window or 0, int(bool(causal)),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"frame attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out


def splash_attention(q, k, v, tokens_per_frame: int, window: Optional[int],
                     causal: bool, doc_id=None, head_chunks: int = 1,
                     scale: Optional[float] = None):
    """q, k, v: [B, H, L, Dh]; doc_id: per-frame [B, n_frames] or None.
    ``head_chunks`` > 1 splits the heads into that many calls (a memory
    lever carried over from the TPU package; same result).
    Returns [B, H, L, Dh] in q's dtype."""
    H = q.shape[1]
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
        return frame_attention_cuda(q, k, v, tokens_per_frame, window,
                                    causal, doc_id, scale)
    raise NotImplementedError(f"no frame attention for device {q.device}")


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
