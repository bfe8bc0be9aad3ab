"""MMDiT dual-stream backbone (counterpart of
owl_audio_exps_tpu/nn/mmattn.py ``MMAttn``, ``MMDiTBlock``, ``MMDiT``).

Video and audio keep separate parameters (``qkv_projs``, ``out_projs``,
``mlps``, index 0 video, 1 audio). For attention the streams are
interleaved per frame, [sample_size ** 2 video tokens | 1 audio token],
into one sequence of the single-stream DiT's layout
(``tokens_per_frame`` = V + 1), QK rms-normed, rotated at the joint
positions and routed as the DiT's attention is (nn/attn.py
``train_attention``: the frame-mask kernel K1, or the band kernels on
local layers whose span divides the sequence, at L >= 1,024 on the card;
the dense masked path otherwise; ``cached_attention`` over the ring), then
split back. The conditioning follows DiT-Air: one shared projection
``cond_proj`` (SiLU, then d -> 12 d, the reference's ``nn.Sequential``
index 1) gives each stream's (scale, bias, gate) of its attention and its
MLP.

Under context parallelism (``sequence_parallel``, parallel/mesh.py) the
streams hold this rank's frames and the interleave runs
parallel/context.py's halo and ring attention at tpf V + 1, as the JAX
package routes the MMDiT's uncached attention (nn/mmattn.py:80-82 through
nn/attn.py:311-330).

``gradient_checkpointing`` recomputes each block in the backward (one
checkpoint per block, whatever ``remat_granularity`` says, as in the JAX
package). A cached forward writes every layer's K and V of all its
tokens into the ring and advances it by all of them: the JAX package's
MMDiT takes no ``write_len`` (owl_audio_exps_tpu/nn/mmattn.py:174-178),
so a fused write-forward of two frames commits both (ROADMAP.md Queue 3).

Spans (utils/profiling.py ``span``, recorded only while a profiler
capture runs): ``owl.mmdit.joint`` from the two streams' qkv outputs to
the q, k and v attention takes (the interleave, the QK norm, RoPE, the
cast), ``owl.mmdit.split`` from attention's output to the two streams'
out-projection inputs, and ``owl.mmdit.audio`` around each of the audio
stream's own calls (its qkv projection, its out projection, its MLP
sub-layer with its adaLN, gate and residual).
``block_forwards`` counts block forwards, remat's recomputes included
(a CUDA graph's replay runs no Python and counts none), always on: a
capture's records hold ``block_forwards`` joint and split spans and
three times as many audio spans.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import dot_attention
from ..ops.norms import rms_norm
from ..ops.rope import rope_table_for
from ..parallel.mesh import seq_parallel_active
from ..utils.profiling import span
from .attn import (build_masks, cached_attention, local_layer_flags,
                   remat_active, sp_train_attention, train_attention,
                   use_splash_path)
from .layers import MLP, Linear, cond_adaln, cond_gate

# MMDiT block forwards since the last reset (set to 0 to reset), remat's
# recomputes included
block_forwards = 0


class MMAttn(nn.Module):
    """Joint attention over the per-frame interleave of the two streams."""

    def __init__(self, config, layer_idx: int, local: bool = False,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.config = config
        self.layer_idx = layer_idx
        self.local = local
        self.dtype = dtype
        d = config.d_model
        kw = dict(dtype=dtype, device=device)
        self.qkv_projs = nn.ModuleList(Linear(d, 3 * d, **kw)
                                       for _ in range(2))
        self.out_projs = nn.ModuleList(Linear(d, d, **kw) for _ in range(2))

    def forward(self, x0, x1, mask, splash: bool = False, kv_cache=None,
                write: bool = False, pos_offset: int = 0):
        """x0 [B, n V, d] video, x1 [B, n, d] audio -> (y0, y1), the
        interleave's first token at position ``pos_offset`` (this rank's
        under context parallelism). With ``kv_cache`` attends over this
        layer's ring and, with ``write``, writes all the new tokens' K and
        V into it."""
        cfg = self.config
        B, n = x1.shape[0], x1.shape[1]
        H = cfg.n_heads
        Dh = cfg.d_model // H
        V = cfg.sample_size ** 2
        tpf = V + 1
        L = n * tpf
        # each stream's [.., 3, H, Dh] rows (the torch reference order),
        # interleaved per frame; q, k, v are views of the joint tensor
        qkv0 = self.qkv_projs[0](x0)
        with span("owl.mmdit.audio"):
            qkv1 = self.qkv_projs[1](x1)
        with span("owl.mmdit.joint"):
            qkv = torch.cat([qkv0.view(B, n, V, 3 * cfg.d_model),
                             qkv1.view(B, n, 1, 3 * cfg.d_model)],
                            dim=2).view(B, L, 3, H, Dh)
            del qkv0, qkv1
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            q, k = rms_norm(q), rms_norm(k)
            rope = rope_table_for(cfg)
            positions = (kv_cache.write_positions(L) if kv_cache is not None
                         else torch.arange(pos_offset, pos_offset + L,
                                           device=x0.device))
            q, k = rope(q, positions), rope(k, positions)
            q, k, v = (t.to(self.dtype) for t in (q, k, v))
        if kv_cache is not None:
            out = cached_attention(cfg, self.layer_idx, self.local, q, k, v,
                                   mask, kv_cache)
            if write:
                kv_cache.write_layer(self.layer_idx, k, v)
        elif seq_parallel_active(cfg):
            out = sp_train_attention(cfg, self.local, q, k, v)
        elif splash:
            out = train_attention(cfg, self.local, q, k, v)
        else:
            out = dot_attention(q, k, v, mask)
        with span("owl.mmdit.split"):
            out = out.transpose(1, 2).reshape(B, n, tpf, cfg.d_model)
            y0 = out[:, :, :V].reshape(B, n * V, cfg.d_model)
            y1 = out[:, :, V]
        y0 = self.out_projs[0](y0)
        with span("owl.mmdit.audio"):
            y1 = self.out_projs[1](y1)
        return y0, y1


class MMDiTBlock(nn.Module):
    """Per-stream modulated attention and MLP under the shared cond."""

    def __init__(self, config, layer_idx: int, local: bool = False,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.config = config
        kw = dict(dtype=dtype, device=device)
        self.attn = MMAttn(config, layer_idx, local, **kw)
        self.mlps = nn.ModuleList(MLP(config.d_model, **kw)
                                  for _ in range(2))

    def forward(self, x0, x1, cond0, cond1, mask, splash: bool = False,
                kv_cache=None, write: bool = False, pos_offset: int = 0):
        global block_forwards
        block_forwards += 1
        a_s0, a_b0, a_g0, m_s0, m_b0, m_g0 = cond0.chunk(6, dim=-1)
        a_s1, a_b1, a_g1, m_s1, m_b1, m_g1 = cond1.chunk(6, dim=-1)
        h0, h1 = self.attn(cond_adaln(x0, a_s0, a_b0),
                           cond_adaln(x1, a_s1, a_b1), mask, splash,
                           kv_cache, write, pos_offset)
        x0 = x0 + cond_gate(h0, a_g0)
        x1 = x1 + cond_gate(h1, a_g1)
        # the chunked MLP in uncached forwards only
        chunks = (self.config.get("mlp_chunks", 1) or 1
                  if kv_cache is None else 1)
        x0 = x0 + cond_gate(self.mlps[0](cond_adaln(x0, m_s0, m_b0), chunks),
                            m_g0)
        with span("owl.mmdit.audio"):
            x1 = x1 + cond_gate(self.mlps[1](cond_adaln(x1, m_s1, m_b1),
                                             chunks), m_g1)
        return x0, x1


class MMDiT(nn.Module):
    """Dual-stream stack with the local/global alternation and the shared
    DiT-Air cond projection."""

    def __init__(self, config, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        d = config.d_model
        kw = dict(dtype=dtype, device=device)
        # index 1 of the reference's nn.Sequential(SiLU, Linear)
        self.cond_proj = nn.ModuleList([nn.SiLU(), Linear(d, 12 * d, **kw)])
        self.blocks = nn.ModuleList(
            MMDiTBlock(config, i, local, **kw)
            for i, local in enumerate(local_layer_flags(config)))

    def forward(self, x0, x1, cond, kv_cache=None, write: bool = False,
                decoding: bool = False, pos_offset: int = 0):
        """x0 [b, n V, d], x1 [b, n, d], cond [b, n, d] -> (x0, x1). With
        ``kv_cache`` every block attends over its ring; ``write`` commits
        every new token (see the module docstring). Under context
        parallelism the streams hold this rank's frames, the interleave's
        first token at ``pos_offset``."""
        cfg = self.config
        L = x0.shape[1] + x1.shape[1]
        splash = kv_cache is None and use_splash_path(cfg, L, x0.device)
        local_mask = global_mask = None
        if kv_cache is not None:
            local_mask, global_mask = build_masks(
                cfg, L, None, kv_cache=kv_cache, decoding=decoding)
        elif not splash and not seq_parallel_active(cfg):
            local_mask, global_mask = build_masks(cfg, L, None,
                                                  device=x0.device)
        y = self.cond_proj[1](F.silu(cond.to(self.dtype)))
        cond0, cond1 = y.chunk(2, dim=-1)
        remat = remat_active(cfg, kv_cache)
        for idx, local in enumerate(local_layer_flags(cfg)):
            args = (x0, x1, cond0, cond1,
                    local_mask if local else global_mask, splash, kv_cache,
                    write, pos_offset)
            if remat:
                x0, x1 = checkpoint(self.blocks[idx], *args,
                                    use_reentrant=False)
            else:
                x0, x1 = self.blocks[idx](*args)
        if kv_cache is not None and write:
            kv_cache.advance(L)
        return x0, x1
