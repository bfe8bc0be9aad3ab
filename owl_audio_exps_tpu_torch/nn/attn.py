"""DiT backbone, uncached path (counterpart of owl_audio_exps_tpu/nn/attn.py).

Fused-QKV attention with QK rms-norm and RoPE; pre-AdaLN blocks with
gates; layers alternate [global, local, local, local, ...]
(``layer_idx % local_idx != 0`` is local).

Routing, with the JAX package's knobs:

* ``attn_impl``: ``auto`` takes the frame-mask flash kernel
  (ops/splash.py) for sequences of at least 1024 tokens on a CUDA device,
  ``splash`` always, ``dense`` never; otherwise the dense mask +
  ``dot_attention`` path runs.
* ``local_attn_impl``: where the JAX router picks its band kernel (a
  causal local window without document packing), ``auto`` and ``splash``
  take the frame-mask kernel here, which computes the same function; a
  pinned ``band``, ``band2`` or ``chunked`` raises, since those kernels
  come with the training slice.

KV-cached forwards (``kv_cache`` not None) come with the cached serve
slice and raise here.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.attention import dot_attention
from ..ops.masks import dense_mask
from ..ops.norms import rms_norm
from ..ops.rope import rope_table_for
from .layers import MLP, AdaLN, Gate, Linear


def use_splash_path(config, q_len: int, device) -> bool:
    """Whether an uncached forward of ``q_len`` tokens on ``device`` runs
    the frame-mask flash kernel (``attn_impl``: auto | dense | splash)."""
    impl = config.get("attn_impl", "auto")
    if impl == "dense":
        return False
    if q_len % config.tokens_per_frame != 0:
        return False
    if impl == "splash":
        return True
    return torch.device(device).type == "cuda" and q_len >= 1024


def build_masks(config, q_len: int, doc_id: Optional[torch.Tensor],
                device=None):
    """(local, global) bool masks [q_len, q_len] (or [b, q_len, q_len]
    with doc_id) for one uncached forward."""
    tpf = config.tokens_per_frame
    causal = bool(config.causal)
    local = dense_mask(q_len, tpf, config.get("local_window"), doc_id, 0,
                       causal, device=device)
    glob = dense_mask(q_len, tpf, config.get("global_window"), doc_id, 0,
                      causal, device=device)
    return local, glob


def train_attention(cfg, local: bool, q, k, v, doc_id=None):
    """Uncached attention dispatch to the frame-mask kernel (see the
    module docstring for the ``local_attn_impl`` routing)."""
    window = cfg.get("local_window") if local else cfg.get("global_window")
    impl = cfg.get("local_attn_impl", "auto")
    if (local and window is not None and bool(cfg.causal) and doc_id is None
            and impl in ("band", "band2", "chunked")):
        raise NotImplementedError(
            f"local_attn_impl={impl!r}: the band and chunked local kernels "
            "are not ported yet (training slice, ROADMAP.md Queue 2); use "
            "'auto' or 'splash'")
    from ..ops.splash import splash_attention
    return splash_attention(q, k, v, cfg.tokens_per_frame, window,
                            bool(cfg.causal), doc_id,
                            head_chunks=cfg.get("splash_head_chunks", 1))


class Attn(nn.Module):
    """Fused-QKV attention with QK rms-norm and RoPE.

    ``qkv.weight`` rows are in the torch reference order [3, H, Dh];
    q, k, v leave the projection as [B, H, L, Dh] views of its
    [B, L, 3, H, Dh] output (no copy), which the kernel reads through
    their strides."""

    def __init__(self, config, layer_idx: int, local: bool = False,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.config = config
        self.layer_idx = layer_idx
        self.local = local
        self.dtype = dtype
        d = config.d_model
        self.qkv = Linear(d, 3 * d, dtype=dtype, device=device)
        self.out = Linear(d, d, dtype=dtype, device=device)

    def forward(self, x, mask, splash: bool = False, doc_id=None):
        cfg = self.config
        B, L, _ = x.shape
        H = cfg.n_heads
        Dh = cfg.d_model // H
        qkv = self.qkv(x).view(B, L, 3, H, Dh)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        q, k = rms_norm(q), rms_norm(k)
        rope = rope_table_for(cfg)
        positions = torch.arange(L, device=x.device)
        q, k = rope(q, positions), rope(k, positions)
        q, k, v = (t.to(self.dtype) for t in (q, k, v))
        if splash:
            out = train_attention(cfg, self.local, q, k, v, doc_id)
        else:
            out = dot_attention(q, k, v, mask)
        return self.out(out.transpose(1, 2).reshape(B, L, cfg.d_model))


class DiTBlock(nn.Module):
    """pre-AdaLN -> attn -> gate -> residual; pre-AdaLN -> MLP -> gate ->
    residual."""

    def __init__(self, config, layer_idx: int, local: bool = False,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        d = config.d_model
        kw = dict(dtype=dtype, device=device)
        self.attn = Attn(config, layer_idx, local, **kw)
        self.adaln1 = AdaLN(d, **kw)
        self.gate1 = Gate(d, **kw)
        self.mlp = MLP(d, **kw)
        self.adaln2 = AdaLN(d, **kw)
        self.gate2 = Gate(d, **kw)

    def forward(self, x, cond, mask, splash: bool = False, doc_id=None):
        x = x + self.gate1(self.attn(self.adaln1(x, cond), mask, splash,
                                     doc_id), cond)
        return x + self.gate2(self.mlp(self.adaln2(x, cond)), cond)


def local_layer_flags(config):
    """[global, local, local, local, ...] alternation."""
    local_idx = config.get("local_idx", 4) or 4
    return [(i % local_idx != 0) for i in range(config.n_layers)]


class DiT(nn.Module):
    """Stack of DiTBlocks with alternating local/global windows."""

    def __init__(self, config, dtype=torch.bfloat16, device=None):
        super().__init__()
        if config.get("scan_layers", False):
            raise NotImplementedError(
                "scan_layers (group-stacked params) is a training-memory "
                "layout; the port keeps unrolled blocks")
        if config.get("sequence_parallel", False):
            raise NotImplementedError(
                "sequence_parallel comes with the context-parallel slice")
        self.config = config
        self.blocks = nn.ModuleList(
            DiTBlock(config, i, local, dtype=dtype, device=device)
            for i, local in enumerate(local_layer_flags(config)))

    def forward(self, x, cond, doc_id=None, kv_cache=None):
        if kv_cache is not None:
            raise NotImplementedError(
                "KV-cached forwards are not ported yet: they come with the "
                "cached serve slice (ROADMAP.md, port slice 5)")
        cfg = self.config
        L = x.shape[1]
        splash = use_splash_path(cfg, L, x.device)
        local_mask = global_mask = None
        if not splash:
            local_mask, global_mask = build_masks(cfg, L, doc_id,
                                                  device=x.device)
        for blk, local in zip(self.blocks, local_layer_flags(cfg)):
            x = blk(x, cond, local_mask if local else global_mask, splash,
                    doc_id)
        return x
