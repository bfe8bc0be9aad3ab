"""Frame-structured attention masks: causal x sliding window x same document
(counterpart of owl_audio_exps_tpu/ops/masks.py, uncached part).

  visible(q, kv) = (frame_kv <= frame_q if causal)
                 & |frame_q - frame_kv| < window_len
                 & doc_id[b, frame_q] == doc_id[b, frame_kv]

with ``frame = token_index // tokens_per_frame``.
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
