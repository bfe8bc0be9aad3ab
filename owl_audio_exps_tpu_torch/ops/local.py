"""Chunk-banded local attention (counterpart of owl_audio_exps_tpu/ops/local.py).

A query in frame f sees frames f - window + 1 .. f. With the sequence cut
into chunks of C = window * tokens_per_frame tokens, a query chunk's
visible keys lie in [previous chunk | own chunk], under one static
[C, 2C] mask. The JAX package computes this in XLA (a scan over chunks),
outside any Pallas kernel; here it is plain PyTorch over all chunks at
once. It is the CPU path of a pinned ``local_attn_impl: chunked`` and of
the sequence-parallel local layer (parallel/context.py), whose halo (the
previous shard's last chunk) takes the place of chunk 0's predecessor.
Same function as ``dot_attention`` under ``dense_mask(L, tpf, window,
doc_id, 0, causal=True)``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .attention import NEG_INF


def chunked_local_available(n_tokens: int, tokens_per_frame: int,
                            window: Optional[int], causal: bool) -> bool:
    """The frame-causal sliding window whose chunk divides the sequence
    into at least two chunks."""
    if window is None or not causal:
        return False
    chunk = window * tokens_per_frame
    return n_tokens % chunk == 0 and n_tokens >= 2 * chunk


def _band_mask(tokens_per_frame: int, window: int, device) -> torch.Tensor:
    """[C, 2C] visibility of a query chunk (frames window .. 2 window - 1
    in local coordinates) over [previous | own] chunk."""
    C = window * tokens_per_frame
    fq = window + torch.arange(C, device=device) // tokens_per_frame
    fk = torch.arange(2 * C, device=device) // tokens_per_frame
    d = fq[:, None] - fk[None, :]
    return (d >= 0) & (d < window)


def chunked_local_attention(q, k, v, tokens_per_frame: int, window: int,
                            doc_id=None, halo_kv=None, halo_valid=None):
    """Frame-causal sliding-window attention over [B, H, L, Dh] q, k, v;
    ``doc_id`` per-frame [B, n_frames] or None. q is scaled by Dh^-0.5 in
    its dtype; logits and softmax in float32, probabilities rounded to
    v's dtype before PV; returns q's dtype.

    ``halo_kv`` (k_halo, v_halo), each [B, H, C, Dh], are the C tokens
    that precede this sequence (the previous shard's tail under context
    parallelism): chunk 0 then attends [halo | chunk 0] as later chunks
    attend their predecessor. ``halo_valid`` False masks the halo off
    (the first shard). Without a halo the sequence needs >= 2 chunks;
    with one, >= 1."""
    B, H, L, Dh = q.shape
    C = window * tokens_per_frame
    nc = L // C
    if L % C or not (nc >= 2 or (halo_kv is not None and nc >= 1)):
        raise ValueError(f"chunked local attention: chunk {C} must divide "
                         f"L = {L} into >= {1 if halo_kv is not None else 2} "
                         "chunks")
    if halo_kv is not None and doc_id is not None:
        raise ValueError("a context-parallel halo with document packing "
                         "is not supported")
    if halo_valid is None:
        halo_valid = halo_kv is not None

    def chunks(a):   # [B, H, nc, C, Dh]
        return a.reshape(B, H, nc, C, Dh)

    qc = chunks((q * Dh ** -0.5).to(q.dtype))
    kc, vc = chunks(k), chunks(v)
    if halo_kv is not None:
        kh, vh = (a.to(k.dtype)[:, :, None] for a in halo_kv)
    else:
        kh, vh = torch.zeros_like(kc[:, :, :1]), torch.zeros_like(vc[:, :, :1])
    kk = torch.cat([torch.cat([kh, kc[:, :, :-1]], 2), kc], 3)  # [.., 2C, Dh]
    vv = torch.cat([torch.cat([vh, vc[:, :, :-1]], 2), vc], 3)

    mask = _band_mask(tokens_per_frame, window, q.device)        # [C, 2C]
    mask = mask.expand(nc, C, 2 * C).clone()
    if not halo_valid:
        mask[0, :, :C] = False   # chunk 0 has no predecessor
    if doc_id is not None:
        tok = doc_id.to(q.device).long().repeat_interleave(
            tokens_per_frame, dim=-1)[:, :L].reshape(B, nc, C)
        prev = torch.cat([torch.zeros_like(tok[:, :1]), tok[:, :-1]], 1)
        dd = torch.cat([prev, tok], -1)                          # [B, nc, 2C]
        mask = mask[None] & (tok[..., :, None] == dd[..., None, :])
        mask = mask[:, None]                                 # [B, 1, nc, C, 2C]

    logits = torch.matmul(qc.float(), kk.float().transpose(-1, -2))
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(vv.dtype)
    out = torch.matmul(probs.float(), vv.float())
    return out.reshape(B, H, L, Dh).to(q.dtype)
