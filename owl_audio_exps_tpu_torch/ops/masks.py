"""Frame-structured attention masks: causal x sliding window x same document
(counterpart of owl_audio_exps_tpu/ops/masks.py).

  visible(q, kv) = (frame_kv <= frame_q if causal)
                 & |frame_q - frame_kv| < window_len
                 & doc_id[b, frame_q] == doc_id[b, frame_kv]

with ``frame = token_index // tokens_per_frame``. ``dense_mask`` serves
uncached forwards; ``decode_mask_from_cache`` serves forwards against the
ring KV cache (nn/kv_cache.py) and is built from the ring's device
counters with tensor ops alone, so it reads no value back to the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def frame_ids(n_tokens: int, tokens_per_frame: int) -> np.ndarray:
    return np.arange(n_tokens, dtype=np.int32) // tokens_per_frame


def dense_mask(
    n_tokens: int,
    tokens_per_frame: int,
    window_len: Optional[int] = None,
    doc_id: Optional[torch.Tensor] = None,
    q_offset: int = 0,
    is_causal: bool = True,
    device=None,
) -> torch.Tensor:
    """Boolean visibility mask [q_len, n_tokens] (or [b, q_len, n_tokens]
    when the per-frame ``doc_id`` [b, n_frames] is given). Queries are the
    trailing ``n_tokens - q_offset`` tokens."""
    assert 0 <= q_offset < n_tokens, "kv cache cannot exceed total tokens"
    if not is_causal:
        assert q_offset == 0, "kv caching not supported with bidirectional"
    if doc_id is not None:
        device = doc_id.device
    n_frames = -(-n_tokens // tokens_per_frame)
    if window_len is None:
        window_len = n_frames

    fid = torch.as_tensor(frame_ids(n_tokens, tokens_per_frame),
                          device=device).long()
    frame_q = fid[q_offset:][:, None]
    frame_kv = fid[None, :]
    mask = (frame_q - frame_kv).abs() < window_len
    if is_causal:
        mask = mask & (frame_kv <= frame_q)
    if doc_id is not None:
        doc_q = doc_id[..., fid[q_offset:]][..., :, None]
        doc_kv = doc_id[..., fid][..., None, :]
        mask = mask & (doc_q == doc_kv)
    return mask


def decode_mask_from_cache(
    slot_rel_idx: torch.Tensor,
    cache_length: torch.Tensor,
    q_len: int,
    tokens_per_frame: int,
    window_len: Optional[int] = None,
    is_causal: bool = True,
    write_len: int = 0,
    capacity: Optional[int] = None,
) -> torch.Tensor:
    """Bool [q_len, S + q_len]: visibility over [cache slots | new tokens].

    ``slot_rel_idx`` [S] is each slot's insertion-order index (>= length:
    invalid), ``cache_length`` the 0-d count of valid cached tokens; the
    queries are ``q_len`` new tokens at positions [length, length +
    q_len). With ``write_len`` > 0 and the ring's ``capacity``, the
    forward commits its leading ``write_len`` tokens mid-flight (the
    fused write): rows past the committed block see the post-commit ring,
    whose oldest tokens a full ring evicts at the commit."""
    dev = slot_rel_idx.device
    rows = torch.arange(q_len, dtype=torch.int32, device=dev)
    q_abs = cache_length + rows
    frame_q = (q_abs // tokens_per_frame)[:, None]
    kv_abs = torch.cat([slot_rel_idx, q_abs])
    new = torch.ones(q_len, dtype=torch.bool, device=dev)
    valid = torch.cat([(slot_rel_idx >= 0) & (slot_rel_idx < cache_length),
                       new])
    frame_kv = (kv_abs // tokens_per_frame)[None, :]

    mask = valid[None, :]
    if write_len and capacity is not None:
        evict = torch.clamp(cache_length + write_len - capacity, min=0)
        post_row = (rows >= write_len)[:, None]
        surviving = torch.cat([slot_rel_idx >= evict, new])
        mask = mask & (~post_row | surviving[None, :])
    if window_len is not None:
        mask = mask & ((frame_q - frame_kv).abs() < window_len)
    if is_causal:
        mask = mask & (frame_kv <= frame_q)
    return mask
