"""The benchmark's yardstick of work: visible attention pairs, model
FLOPs, each attention kernel's bound, and the peaks of the card.

Peaks: one NVIDIA H100 SXM at its 700 W limit, dense bf16, from NVIDIA's
data sheet: 989 TFLOP/s and 3.35 TB/s of HBM3.

A kernel's bound is max(FLOPs / peak, bytes / bandwidth) over the pairs
its mask leaves visible: the forward 4 Dh FLOPs a pair, K1's dq 6 and
dkv 8, the band's whole backward 10; bytes are each input read once and
each output written once (bf16 tensors of B H L Dh, float32 statistics
of B H L). Model FLOPs are the forward's matmuls (projections, MLPs,
the per-frame modulation and embeddings) plus attention over the
visible pairs, and a training step counts three forwards (recompute not
counted).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def frame_vis(n_frames: int, window: Optional[int], causal: bool,
              doc=None) -> np.ndarray:
    """[n, n] bool frame visibility of one batch row (``doc`` per-frame
    ids or None)."""
    f = np.arange(n_frames)
    d = f[:, None] - f[None, :]
    vis = np.ones((n_frames, n_frames), bool)
    if window is not None:
        vis &= np.abs(d) < window
    if causal:
        vis &= d >= 0
    if doc is not None:
        doc = np.asarray(doc)
        vis &= doc[:, None] == doc[None, :]
    return vis


def visible_pairs(n_frames: int, tpf: int, window, causal, doc=None) -> int:
    """Visible (query, key) token pairs of one head and one batch row."""
    return int(frame_vis(n_frames, window, causal, doc).sum()) * tpf * tpf


def layer_windows(cfg) -> List[Optional[int]]:
    """Each layer's window in frames (None: global)."""
    k = cfg.get("local_idx", 4) or 4
    return [cfg.get("local_window") if i % k else cfg.get("global_window")
            for i in range(cfg["n_layers"])]


def matmul_flops(cfg, frames: int, batch: int) -> float:
    """Forward matmul FLOPs of the model over ``batch`` rows of
    ``frames`` frames."""
    d, nl = cfg["d_model"], cfg["n_layers"]
    tpf = cfg["tokens_per_frame"]
    tokens, rows = batch * frames * tpf, batch * frames
    per_token = nl * 2 * (3 * d * d + d * d + 8 * d * d)
    per_frame = nl * 2 * (2 * d * d + d * d) * 2       # adaLN x2, gate x2
    per_frame += 2 * (512 * 4 * d + 4 * d * d)          # timestep MLP
    if not cfg.get("uncond", False):
        per_frame += 2 * (2 * 256 + 512 * 2048 + 2048 * d)       # mouse
        per_frame += 2 * (cfg["n_buttons"] * 2048 + 2048 * d)    # buttons
    video_tokens = batch * frames * cfg["sample_size"] ** 2
    flops = tokens * per_token + rows * per_frame
    flops += video_tokens * 2 * 2 * cfg["channels"] * d   # proj in / out
    flops += rows * 2 * d * 2 * d                         # final adaLN
    if cfg.get("has_audio", False):
        flops += rows * 2 * (2 * cfg["audio_channels"] * d + 2 * d * d)
    return float(flops)


def attention_pairs(cfg, frames: int, docs) -> float:
    """Visible pairs over every layer and head of one forward; ``docs``
    is a list with one per-frame id row (or None) per batch row."""
    tpf, H = cfg["tokens_per_frame"], cfg["n_heads"]
    causal = bool(cfg.get("causal", True))
    total = 0
    cache = {}
    for w in layer_windows(cfg):
        for doc in docs:
            key = (w, None if doc is None else tuple(np.asarray(doc)))
            if key not in cache:
                cache[key] = visible_pairs(frames, tpf, w, causal, doc)
            total += cache[key]
    return float(total * H)


def train_step_flops(cfg, frames: int, docs) -> float:
    """FLOPs of one training step: three forwards, attention over the
    visible pairs (4 Dh FLOPs a pair)."""
    dh = cfg["d_model"] // cfg["n_heads"]
    fwd = matmul_flops(cfg, frames, len(docs)) + \
        4 * dh * attention_pairs(cfg, frames, docs)
    return 3.0 * fwd


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def forwards_per_layer(cfg) -> List[int]:
    """Attention forwards of each layer in a training step under the
    config's remat: 1 without it; with group remat 3 (the forward, the
    group's and the block's recompute), 2 for the last block of a group,
    whose output the group's recompute does not need; 2 per block
    otherwise."""
    n = cfg["n_layers"]
    if not cfg.get("gradient_checkpointing", False):
        return [1] * n
    if cfg.get("remat_granularity") != "group":
        return [2] * n
    k = cfg.get("local_idx", 4) or 4
    return [2 if (i % k == k - 1 or i == n - 1) else 3 for i in range(n)]


def attention_route(cfg, window, L: int, packed: bool) -> str:
    """"k1" or "band" for a layer of ``window`` frames: a causal local
    window without documents whose span C (a multiple of 8, at least
    128) divides the sequence into two chunks or more takes a band
    kernel; the rest take the frame-mask kernel K1."""
    tpf = cfg["tokens_per_frame"]
    if window is None or packed or not cfg.get("causal", True):
        return "k1"
    C = window * tpf
    band = L % C == 0 and L >= 2 * C and C % 8 == 0 and C >= 128
    return "band" if band else "k1"


def attention_bounds(cfg, frames: int, docs):
    """(seconds of bound, {kernel: launches}) of one training step's
    attention kernels over the batch ``docs`` (ids per row or None)."""
    tpf, H = cfg["tokens_per_frame"], cfg["n_heads"]
    dh = cfg["d_model"] // H
    B, L = len(docs), frames * tpf
    causal = bool(cfg.get("causal", True))
    packed = any(d is not None for d in docs)
    elems, stats = B * H * L * dh, B * H * L
    total, launches = 0.0, {"k1_fwd": 0, "k1_dq": 0, "k1_dkv": 0,
                            "band_fwd": 0, "band_bwd": 0}
    for w, n_fwd in zip(layer_windows(cfg), forwards_per_layer(cfg)):
        pairs = H * sum(visible_pairs(frames, tpf, w, causal, d)
                        for d in docs)
        if attention_route(cfg, w, L, packed) == "k1":
            total += n_fwd * bound_s(4 * dh * pairs, 8 * elems + 4 * stats)
            total += bound_s(6 * dh * pairs, 12 * elems + 8 * stats)
            total += bound_s(8 * dh * pairs, 12 * elems + 8 * stats)
            launches["k1_fwd"] += n_fwd
            launches["k1_dq"] += 1
            launches["k1_dkv"] += 1
        else:
            total += n_fwd * bound_s(4 * dh * pairs, 8 * elems + 4 * stats)
            total += bound_s(10 * dh * pairs, 16 * elems + 4 * stats)
            launches["band_fwd"] += n_fwd
            launches["band_bwd"] += 1
    return total, launches


def serve_tick_flops(cfg, ring: int, steps: int = 2) -> float:
    """Model FLOPs of one steady tick with a full ring of ``ring``
    frames: the pending frame over [ring | itself], then ``steps``
    forwards of the new frame over [ring | itself]; global layers see
    the whole ring, local ones ``local_window`` frames."""
    tpf, H = cfg["tokens_per_frame"], cfg["n_heads"]
    dh = cfg["d_model"] // H
    per_fwd = matmul_flops(cfg, 1, 1)
    keys = 0
    for win in layer_windows(cfg):
        seen = ring + 1 if win is None else min(win, ring + 1)
        keys += seen * tpf
    per_fwd += 4 * dh * H * tpf * keys
    return float((1 + steps) * per_fwd)
