"""DiT backbone, uncached path (counterpart of owl_audio_exps_tpu/nn/attn.py).

Fused-QKV attention with QK rms-norm and RoPE; pre-AdaLN blocks with
gates; layers alternate [global, local, local, local, ...]
(``layer_idx % local_idx != 0`` is local).

Routing, with the JAX package's knobs (``train_attention`` follows the
precedence of owl_audio_exps_tpu/nn/attn.py:155-218):

* ``attn_impl``: ``auto`` takes the kernels (ops/splash.py, ops/band.py,
  ops/band2.py) for sequences of at least 1024 tokens on a CUDA device,
  ``splash`` always, ``dense`` never; otherwise the dense mask +
  ``dot_attention`` path runs.
* ``local_attn_impl`` (``attention_route``): a causal local window
  without document packing whose span C divides the sequence
  (``band_available``) takes a band kernel, with the fixed-shift softmax
  at bound sqrt(Dh) unless ``band_fixed_shift: false``. Which one follows
  the JAX package (owl_audio_exps_tpu/nn/attn.py:170-203): ``auto``
  keeps the band (K2/K3's port, ops/band.py) where the span is
  frame-exact (``use_frame_exact``: C % 128 == 0 and tpf % 8 == 0, e.g.
  dit_v4), and elsewhere, unless ``band_v2: false``, takes band2 (K5's
  port, ops/band2.py) with ``best_plan``'s (S, m) where there is one (the
  AV model's tpf 65: (520, 2) at a 16-frame window). A pinned ``band2``
  takes ``best_plan``'s plan at any tpf and raises ValueError where there
  is none; with ``band_v2: false`` it takes the band, as in the JAX
  package. A pinned ``band`` keeps the band, and a pinned ``band`` or
  ``band2`` raises where the span does not divide the sequence. A pinned
  ``chunked`` runs ops/local.py (plain PyTorch, as the JAX package runs
  it in XLA) where its chunk divides the sequence, and raises elsewhere;
  ``splash`` pins the frame-mask kernel. Global layers, document-packed
  batches, bidirectional and indivisible windows take the frame-mask
  kernel (K1).
* ``sequence_parallel``: when the mesh's seq axis holds more than one
  rank (parallel/mesh.py), every uncached forward runs on this rank's
  slice of the frames, at their global RoPE positions, and attention
  goes through parallel/context.py (halo exchange on local layers, ring
  attention with K4 on global ones), ahead of the routing above, as at
  owl_audio_exps_tpu/nn/attn.py:311-330. It needs a causal model and no
  document packing.

* ``pipeline_parallel`` (parallel/pipeline.py): on a mesh with an
  engaged pipe axis, with ``scan_layers`` and ``n_layers`` a multiple of
  ``local_idx``, an uncached forward runs this rank's stage of the blocks
  (whole groups) in a GPipe schedule of ``pipeline_microbatches``
  micro-batches, each block checkpointed under
  ``gradient_checkpointing``, as at owl_audio_exps_tpu/nn/attn.py:
  565-590; document packing is refused there. Without those conditions
  every pipe rank runs the whole stack.

Training: ``gradient_checkpointing`` recomputes each block in the
backward (``torch.utils.checkpoint``, non-reentrant); with
``remat_granularity: group`` each local/global period of ``local_idx``
blocks is checkpointed and each block inside it again, as the JAX
package nests its remat (nn/attn.py:633-658); inside a torch.func
transform (the jvp of models/gamemft_audio.py) the blocks run without it,
as the checkpoint's recompute cannot replay the transform's tensors.
``scan_layers`` (the JAX package's stacking of each period's parameters
for ``nn.scan``, an XLA layout with no counterpart here) runs the same
layer loop and remat: the function is unchanged. The memory knobs, each
with the values of the plain run (owl_audio_exps_tpu/nn/attn.py:436-485,
:690-731, nn/layers.py:101-137):

* ``remat_sequenced`` (with ``gradient_checkpointing``, on the kernel
  path without documents, as the JAX package takes it): one checkpoint
  per block, whatever ``remat_granularity`` says; the backward
  recomputes one block at a time, after the next block's backward;
* ``fused_head_chunks`` with ``splash_head_chunks`` n > 1 (uncached, on
  the kernel path, not under context parallelism): QK-norm, RoPE and the
  kernel run per slice of H / n heads;
* ``mlp_chunks``: every uncached block's MLP runs over that many chunks
  of the sequence (nn/layers.py ``MLP``).

``UViT`` is the DiT with U-Net skips: every block global, block i of the
second half fed ``SkipConnection``(its input, the output of block n-1-i).

KV-cached forwards (``kv_cache`` not None, nn/kv_cache.py) follow
owl_audio_exps_tpu/nn/attn.py:68-139 and :221-309. The masks come from
the ring's device counters (``build_masks``): ``decode_mask_from_cache``
over [ring slots | new tokens], with the fused write's eviction rows
under ``write_len``; under ``decoding`` validity alone, local layers cut
to their trailing ``local_window`` frames. A decoding local layer whose
window is shorter than the ring gathers its trailing window from its
ring (``can_local_gather``). ``decode_impl`` takes ``auto`` or ``dense``.
Under ``auto`` a call whose tensors the decode kernel takes (CUDA, bf16
or fp16 q and ring, Dh 64 or 128, no gradient; not an int8 ring:
ops/decode_attention.py ``accepts``) runs it, reading the ring in place;
every other call, and every call under ``dense``, is plain PyTorch, as
the JAX package's is plain XLA there (it has no decode kernel):
``cache_attn_impl`` ``concat`` (``dot_attention`` over the concatenated
K/V) or ``noconcat`` (``cached_dot_attention``), counted in
``dense_calls``.
RoPE positions start at the ring's ``rope_offset``. With ``write``, each
layer writes the leading ``write_len`` tokens (all by default) of its
rotated K and V into its own ring right after its attention has read it,
and the counters advance once, after the last layer.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import decode_attention
from ..ops.attention import cached_dot_attention, dot_attention
from ..ops.masks import decode_mask_from_cache, dense_mask
from ..ops.norms import rms_norm
from ..ops.rope import rope_table_for
from ..parallel.mesh import get_mesh, seq_parallel_active
from ..parallel.pipeline import pipeline_active, stage_blocks
from .layers import MLP, AdaLN, Gate, Linear


# cached_attention calls routed to dot_attention / cached_dot_attention
# since the last reset (set to 0 to reset); the decode kernel's own count
# is ops/decode_attention.py ``launches``
dense_calls = 0


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


def can_local_gather(config, q_len: int, kv_cache) -> bool:
    """Whether a decoding local layer gathers its trailing window from its
    ring instead of masking the whole ring."""
    local_w = config.get("local_window")
    if kv_cache is None or local_w is None:
        return False
    span = local_w * config.tokens_per_frame
    return span > q_len and span < kv_cache.capacity


def build_masks(config, q_len: int, doc_id: Optional[torch.Tensor],
                device=None, kv_cache=None, decoding: bool = False,
                write_len: Optional[int] = None):
    """(local, global) bool masks of one forward: [q_len, q_len] (or [b,
    q_len, q_len] with doc_id) without a cache; [q_len, alloc + q_len]
    over [ring slots | new tokens] with one, each mask indexing the slots
    of the ring its layers read. A decoding forward's local mask is None
    where its layers gather their window (``can_local_gather``)."""
    tpf = config.tokens_per_frame
    local_w = config.get("local_window")
    global_w = config.get("global_window")
    causal = bool(config.causal)
    if kv_cache is None:
        local = dense_mask(q_len, tpf, local_w, doc_id, 0, causal,
                           device=device)
        glob = dense_mask(q_len, tpf, global_w, doc_id, 0, causal,
                          device=device)
        return local, glob

    rel = kv_cache.slot_rel_idx()
    length = kv_cache.length
    lrel = kv_cache.slot_rel_idx(local=True)
    lcap, _, _, llength = kv_cache.ring_view(True)
    new = torch.ones(q_len, dtype=torch.bool, device=rel.device)
    if decoding:
        # visibility is slot validity (and the new tokens); local layers
        # see the trailing local_window frames of [ring | new]
        valid = torch.cat([rel < length, new])
        glob = valid[None, :].expand(q_len, rel.shape[0] + q_len)
        if can_local_gather(config, q_len, kv_cache):
            local = None
        elif local_w is not None:
            q_abs = llength + torch.arange(q_len, dtype=torch.int32,
                                           device=rel.device)
            kv_order = torch.cat([lrel, q_abs])
            lvalid = torch.cat([lrel < llength, new])
            cutoff = llength + q_len - local_w * tpf
            local = (lvalid & (kv_order >= cutoff))[None, :].expand(
                q_len, lrel.shape[0] + q_len)
        else:
            local = glob
        return local, glob

    # the fused write: rows past the committed block see the post-commit
    # ring; wl 0 when the whole forward is committed
    wl = 0 if (write_len is None or write_len >= q_len) else write_len
    if wl and global_w is not None and global_w * tpf < kv_cache.capacity:
        # decoding masks are validity alone, so a finite global window
        # would make fused and unfused ticks differ
        raise ValueError(
            "fused write-forward (write_len) requires global_window=None "
            "or >= ring capacity: decode masks are validity-only, so a "
            "finite global window would break fused/unfused equivalence")
    local = decode_mask_from_cache(lrel, llength, q_len, tpf, local_w, causal,
                                   write_len=wl, capacity=lcap)
    glob = decode_mask_from_cache(rel, length, q_len, tpf, global_w, causal,
                                  write_len=wl, capacity=kv_cache.capacity)
    return local, glob


def band_logit_bound(cfg, q) -> Optional[float]:
    """The band kernel's fixed-shift bound: sqrt(Dh), which QK rms-norm
    makes exact, unless ``band_fixed_shift: false``."""
    return (float(q.shape[-1]) ** 0.5 if cfg.get("band_fixed_shift", True)
            else None)


def sp_train_attention(cfg, local: bool, q, k, v, doc_id=None):
    """Context-parallel attention of this rank's slice (parallel/
    context.py), with the JAX package's preconditions."""
    from ..parallel.context import sp_attention
    if doc_id is not None:
        raise ValueError("sequence_parallel with document packing is not "
                         "supported")
    if not bool(cfg.causal):
        raise ValueError("sequence_parallel requires a causal model (the "
                         "halo and ring hard-code frame-causal visibility)")
    window = cfg.get("local_window") if local else cfg.get("global_window")
    return sp_attention(q, k, v, cfg.tokens_per_frame, window,
                        logit_bound=band_logit_bound(cfg, q))


def attention_route(cfg, local: bool, L: int, doc_id=None):
    """The kernel an uncached forward of L tokens takes on a local
    (``local``) or global layer, with its band2 plan: ("band2", (S, m)),
    ("band", None), ("chunked", None) or ("splash", None). Raises where a
    pinned kernel does not apply (see the module docstring)."""
    from ..ops.band import band_available, use_frame_exact
    from ..ops.band2 import best_plan
    from ..ops.local import chunked_local_available
    tpf = cfg.tokens_per_frame
    window = cfg.get("local_window") if local else cfg.get("global_window")
    impl = cfg.get("local_attn_impl", "auto")
    if not (local and window is not None and impl != "splash"
            and bool(cfg.causal) and doc_id is None):
        return "splash", None
    geometry = f"(L={L}, tpf={tpf}, window={window})"
    if impl == "chunked":
        if not chunked_local_available(L, tpf, window, True):
            raise ValueError(
                f"local_attn_impl=chunked requires a causal local window "
                f"whose span divides the sequence into >= 2 chunks "
                f"{geometry}")
        return "chunked", None
    if band_available(L, tpf, window, True):
        fw_auto = impl == "auto" and use_frame_exact(window * tpf, tpf)
        if impl in ("auto", "band2") and not fw_auto \
                and cfg.get("band_v2", True):
            plan = best_plan(L, tpf, window)
            if plan is not None:
                return "band2", plan
            if impl == "band2":
                raise ValueError(f"local_attn_impl=band2: no legal band2 "
                                 f"plan {geometry}")
        return "band", None
    if impl in ("band", "band2"):
        raise ValueError(
            f"local_attn_impl={impl} requires a causal local window whose "
            f"span divides the sequence {geometry}")
    return "splash", None


def train_attention(cfg, local: bool, q, k, v, doc_id=None,
                    head_chunks: Optional[int] = None):
    """Uncached attention dispatch to the band2, band or frame-mask kernel
    (see the module docstring for the precedence); ``head_chunks``
    defaults to ``splash_head_chunks``."""
    from ..ops.band import band_attention
    from ..ops.band2 import band2_attention
    from ..ops.local import chunked_local_attention
    from ..ops.splash import splash_attention
    tpf = cfg.tokens_per_frame
    window = cfg.get("local_window") if local else cfg.get("global_window")
    if head_chunks is None:
        head_chunks = cfg.get("splash_head_chunks", 1)
    route, plan = attention_route(cfg, local, q.shape[2], doc_id)
    if route == "band2":
        return band2_attention(q, k, v, tpf, window, *plan,
                               head_chunks=head_chunks,
                               logit_bound=band_logit_bound(cfg, q))
    if route == "band":
        return band_attention(q, k, v, tpf, window, head_chunks=head_chunks,
                              logit_bound=band_logit_bound(cfg, q))
    if route == "chunked":
        return chunked_local_attention(q, k, v, tpf, window)
    return splash_attention(q, k, v, tpf, window, bool(cfg.causal), doc_id,
                            head_chunks=head_chunks)


def cached_attention(cfg, layer_idx: int, local: bool, q, k, v, mask,
                     kv_cache):
    """Attention of new tokens q, k, v [B, H, L, Dh] (normed, rotated, in
    the compute dtype) over [layer's ring | new tokens]: the decode kernel
    (ops/decode_attention.py) under ``decode_impl: auto`` where it takes
    the call, else ``dot_attention`` / ``cached_dot_attention`` (counted in
    ``dense_calls``)."""
    global dense_calls
    impl = cfg.get("decode_impl", "auto")
    if impl not in ("auto", "dense"):
        raise ValueError(
            f"decode_impl={impl!r}: valid values are 'auto' (the decode "
            "kernel where it takes the call) and 'dense'")
    noconcat = cfg.get("cache_attn_impl", "concat") == "noconcat"
    L, dtype = q.shape[2], q.dtype
    if mask is None and local and can_local_gather(cfg, L, kv_cache):
        # a decoding local layer sees the trailing local_window frames of
        # [ring | new]: its ring's trailing window, then the new tokens
        n_gather = cfg.get("local_window") * cfg.tokens_per_frame - L
        ck, cv, valid = kv_cache.gather_trailing(layer_idx, n_gather,
                                                 local=True)
        mask = torch.cat([valid, torch.ones(L, dtype=torch.bool,
                                            device=valid.device)])[None, :]
    else:
        ck, cv = kv_cache.read_layer(layer_idx)
    if (impl == "auto" and not kv_cache.quantized
            and decode_attention.accepts(q, ck, cv, k, v, mask)):
        return decode_attention.decode_attention_cuda(q, ck, cv, k, v, mask)
    dense_calls += 1
    ck, cv = ck.to(dtype), cv.to(dtype)
    if noconcat:
        return cached_dot_attention(q, ck, cv, k, v, mask)
    return dot_attention(q, torch.cat([ck, k], dim=2),
                         torch.cat([cv, v], dim=2), mask)


class Attn(nn.Module):
    """Fused-QKV attention with QK rms-norm and RoPE.

    ``qkv.weight`` rows are in the torch reference order [3, H, Dh];
    q, k, v leave the projection as [B, H, L, Dh] views of its
    [B, L, 3, H, Dh] output (no copy), which the kernel reads through
    their strides. Under the tensor axis (parallel/sharding.py) ``qkv``
    is column-parallel and ``out`` row-parallel: H is this rank's H / T
    heads, and its ring (``kv_cache``) holds those heads alone."""

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

    def forward(self, x, mask, splash: bool = False, doc_id=None,
                pos_offset: int = 0, kv_cache=None,
                write_len: Optional[int] = None):
        """With ``kv_cache``, attends over this layer's ring and, when
        ``write_len`` is given, writes the leading ``write_len`` tokens'
        K and V into it."""
        cfg = self.config
        B, L, _ = x.shape
        Dh = cfg.d_model // cfg.n_heads
        qkv = self.qkv(x)
        # this rank's heads: all of them, or H / T under the tensor axis
        H = qkv.shape[-1] // (3 * Dh)
        qkv = qkv.view(B, L, 3, H, Dh)
        rope = rope_table_for(cfg)
        if kv_cache is not None:
            positions = kv_cache.write_positions(L)
        else:
            positions = torch.arange(pos_offset, pos_offset + L,
                                     device=x.device)
        hc = cfg.get("splash_head_chunks", 1) or 1
        if (splash and kv_cache is None and hc > 1
                and cfg.get("fused_head_chunks", False)
                and not seq_parallel_active(cfg)
                and H % hc == 0 and H > hc):
            # QK-norm, RoPE and the kernel per slice of H / hc heads;
            # context parallelism takes precedence, as in the JAX package
            Hc = H // hc
            outs = []
            for c in range(hc):
                q, k, v = (qkv[:, :, i, c * Hc:(c + 1) * Hc].transpose(1, 2)
                           for i in range(3))
                q, k = rms_norm(q), rms_norm(k)
                q, k = rope(q, positions), rope(k, positions)
                o = train_attention(cfg, self.local, q.to(self.dtype),
                                    k.to(self.dtype), v.to(self.dtype),
                                    doc_id, head_chunks=1)
                outs.append(o.transpose(1, 2).reshape(B, L, Hc * Dh))
            return self.out(torch.cat(outs, dim=-1))
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        q, k = rms_norm(q), rms_norm(k)
        q, k = rope(q, positions), rope(k, positions)
        q, k, v = (t.to(self.dtype) for t in (q, k, v))
        if kv_cache is not None:
            out = cached_attention(cfg, self.layer_idx, self.local, q, k, v,
                                   mask, kv_cache)
            if write_len is not None:
                kv_cache.write_layer(self.layer_idx, k[:, :, :write_len],
                                     v[:, :, :write_len])
        elif seq_parallel_active(cfg):
            out = sp_train_attention(cfg, self.local, q, k, v, doc_id)
        elif splash:
            out = train_attention(cfg, self.local, q, k, v, doc_id)
        else:
            out = dot_attention(q, k, v, mask)
        return self.out(out.transpose(1, 2).reshape(B, L, H * Dh))


class DiTBlock(nn.Module):
    """pre-AdaLN -> attn -> gate -> residual; pre-AdaLN -> MLP -> gate ->
    residual."""

    def __init__(self, config, layer_idx: int, local: bool = False,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.config = config
        d = config.d_model
        kw = dict(dtype=dtype, device=device)
        self.attn = Attn(config, layer_idx, local, **kw)
        self.adaln1 = AdaLN(d, **kw)
        self.gate1 = Gate(d, **kw)
        self.mlp = MLP(d, **kw)
        self.adaln2 = AdaLN(d, **kw)
        self.gate2 = Gate(d, **kw)

    def forward(self, x, cond, mask, splash: bool = False, doc_id=None,
                pos_offset: int = 0, kv_cache=None,
                write_len: Optional[int] = None):
        x = x + self.gate1(self.attn(self.adaln1(x, cond), mask, splash,
                                     doc_id, pos_offset, kv_cache,
                                     write_len), cond)
        # the chunked MLP in uncached forwards only
        chunks = (self.config.get("mlp_chunks", 1) or 1
                  if kv_cache is None else 1)
        return x + self.gate2(self.mlp(self.adaln2(x, cond), chunks), cond)


def local_layer_flags(config):
    """[global, local, local, local, ...] alternation."""
    local_idx = config.get("local_idx", 4) or 4
    return [(i % local_idx != 0) for i in range(config.n_layers)]


def attention_forwards_per_step(config):
    """Attention forwards of each layer in one training step (forward and
    backward) under the config's remat: 1 without
    ``gradient_checkpointing``; 2 with per-block remat (the backward
    recomputes each block once); with ``remat_granularity: group``, 3
    (the forward, the group's recompute, the block's own recompute),
    except for the last block of each group: the group's recompute does
    not need that block's output, and non-reentrant checkpointing stops a
    recompute once it has what the backward asked for, so that block runs
    twice. The MMDiT, the UViT and ``remat_sequenced`` on the kernel path
    take per-block remat: 2. Each layer's attention backward runs once."""
    n = config.n_layers
    if not config.get("gradient_checkpointing", False):
        return [1] * n
    # the MMDiT and the UViT checkpoint each block; sequenced remat too
    if (config.get("remat_granularity") != "group"
            or config.get("backbone", "dit") != "dit"
            or config.get("remat_sequenced", False)):
        return [2] * n
    K = config.get("local_idx", 4) or 4
    return [2 if (i % K == K - 1 or i == n - 1) else 3 for i in range(n)]


def remat_active(config, kv_cache=None) -> bool:
    """Whether an uncached forward checkpoints its blocks: with
    ``gradient_checkpointing``, under autograd, and outside a torch.func
    transform (MeanFlow's jvp), whose tensors the checkpoint's recompute
    in the backward would not see; remat changes no value."""
    return (config.get("gradient_checkpointing", False)
            and kv_cache is None and torch.is_grad_enabled()
            and not torch._C._are_functorch_transforms_active())


class DiT(nn.Module):
    """Stack of DiTBlocks with alternating local/global windows."""

    def __init__(self, config, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.config = config
        # under the pipeline a rank allocates its stage's blocks only: the
        # others are built on the meta device (nn/layers.py
        # ``reset_parameters`` still draws their weights from the
        # generator, so the kept ones are one process's, and drops them;
        # parallel/sharding.py ``split_stages`` removes them)
        keep = None
        if pipeline_active(config):
            mesh = get_mesh()
            keep = stage_blocks(config, mesh.pipe, mesh.pipe_index)
        self.blocks = nn.ModuleList(
            DiTBlock(config, i, local, dtype=dtype,
                     device=device if keep is None or i in keep else "meta")
            for i, local in enumerate(local_layer_flags(config)))
        for i in keep or ():
            for p in self.blocks[i].parameters():
                p.pipe_stage = mesh.pipe_index

    def _run_blocks(self, start, stop, x, cond, local_mask, global_mask,
                    splash, doc_id, pos_offset, remat):
        flags = local_layer_flags(self.config)
        for idx in range(start, stop):
            mask = local_mask if flags[idx] else global_mask
            if remat:
                x = checkpoint(self.blocks[idx], x, cond, mask, splash,
                               doc_id, pos_offset, use_reentrant=False)
            else:
                x = self.blocks[idx](x, cond, mask, splash, doc_id,
                                     pos_offset)
        return x

    def forward(self, x, cond, doc_id=None, kv_cache=None,
                pos_offset: int = 0, write: bool = False,
                decoding: bool = False, write_len: Optional[int] = None):
        """x: [B, L, d] tokens. Under context parallelism (see the module
        docstring) x is this rank's slice and ``pos_offset`` the global
        position of its first token. With ``kv_cache`` the forward attends
        over the ring; ``write`` commits the leading ``write_len`` tokens
        (all by default) to it, and ``decoding`` takes the decoding
        masks."""
        if kv_cache is not None:
            return self._cached(x, cond, doc_id, kv_cache, write, decoding,
                                write_len)
        cfg = self.config
        L, n = x.shape[1], cfg.n_layers
        splash = use_splash_path(cfg, L, x.device)
        local_mask = global_mask = None
        if not splash and not seq_parallel_active(cfg):
            local_mask, global_mask = build_masks(cfg, L, doc_id,
                                                  device=x.device)
        args = (cond, local_mask, global_mask, splash, doc_id, pos_offset)
        remat = remat_active(cfg)
        if pipeline_active(cfg):
            return self._pipelined(x, *args, remat)
        if (remat and cfg.get("remat_sequenced", False)
                and local_mask is None and doc_id is None):
            # sequenced remat: one checkpoint per block, recomputed in the
            # backward one block at a time
            return self._run_blocks(0, n, x, *args, True)
        if remat and cfg.get("remat_granularity") == "group":
            # one checkpoint per local/global period, and one per block
            # inside it (the group's backward then holds one block's
            # activations at a time)
            K = cfg.get("local_idx", 4) or 4
            for start in range(0, n, K):
                x = checkpoint(self._run_blocks, start, min(start + K, n),
                               x, *args, True, use_reentrant=False)
            return x
        return self._run_blocks(0, n, x, *args, remat)

    def _pipelined(self, x, cond, local_mask, global_mask, splash, doc_id,
                   pos_offset, remat):
        """This rank's stage of the blocks in the pipeline's GPipe
        schedule (parallel/pipeline.py), each block checkpointed under
        remat, as the JAX package's scanned group runs them."""
        from ..parallel.mesh import get_mesh
        from ..parallel.pipeline import pipeline_apply, stage_blocks
        cfg = self.config
        if doc_id is not None:
            raise ValueError(
                "pipeline_parallel + document packing unsupported")
        mesh = get_mesh()
        stage = stage_blocks(cfg, mesh.pipe, mesh.pipe_index)

        def run_stage(h, c):
            return self._run_blocks(stage.start, stage.stop, h, c,
                                    local_mask, global_mask, splash, None,
                                    pos_offset, remat)

        return pipeline_apply(
            mesh, run_stage, x, cond,
            int(cfg.get("pipeline_microbatches") or mesh.pipe))

    def _cached(self, x, cond, doc_id, kv_cache, write, decoding, write_len):
        cfg = self.config
        if any(b is None for b in self.blocks):
            # the JAX package's cached forward runs unrolled blocks, which
            # a scan_layers model (every pipelined one) does not hold: its
            # eval sample at a pipe mesh raises ScopeParamNotFoundError
            raise ValueError(
                "a cached forward of a DiT whose blocks are split over "
                "pipeline stages: this rank holds only its stage's blocks, "
                "and the JAX package refuses a cached forward of a "
                "pipelined scan_layers model as well")
        L = x.shape[1]
        local_mask, global_mask = build_masks(
            cfg, L, doc_id, kv_cache=kv_cache, decoding=decoding,
            write_len=write_len if write else None)
        wl = (L if write_len is None else write_len) if write else None
        for idx, local in enumerate(local_layer_flags(cfg)):
            x = self.blocks[idx](x, cond, local_mask if local else global_mask,
                                 False, doc_id, 0, kv_cache, wl)
        if write:
            kv_cache.advance(wl)
        return x


class SkipConnection(nn.Module):
    """U-Net skip join: add, AdaLN, project."""

    def __init__(self, config, dtype=torch.bfloat16, device=None):
        super().__init__()
        d = config.d_model
        self.norm = AdaLN(d, dtype=dtype, device=device)
        self.proj = Linear(d, d, dtype=dtype, device=device)

    def forward(self, x, prev, cond):
        return self.proj(self.norm(x + prev, cond))


class UViT(nn.Module):
    """DiT blocks, all on the global window, with U-Net skips: the outputs
    of the first n // 2 blocks are joined (``skip_projs``) to the inputs
    of the blocks after the middle one, in reverse order."""

    def __init__(self, config, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.config = config
        n = config.n_layers
        kw = dict(dtype=dtype, device=device)
        self.blocks = nn.ModuleList(DiTBlock(config, i, False, **kw)
                                    for i in range(n))
        self.skip_projs = nn.ModuleList(SkipConnection(config, **kw)
                                        for _ in range(n - n // 2 - 1))

    def forward(self, x, cond, doc_id=None, kv_cache=None,
                pos_offset: int = 0, write: bool = False,
                decoding: bool = False, write_len: Optional[int] = None):
        """As ``DiT.forward``: with ``kv_cache`` every block attends over
        its ring, and ``write`` commits the leading ``write_len`` tokens
        (all by default)."""
        cfg = self.config
        L = x.shape[1]
        splash = kv_cache is None and use_splash_path(cfg, L, x.device)
        mask = None
        if kv_cache is not None:
            mask = build_masks(cfg, L, doc_id, kv_cache=kv_cache,
                               decoding=decoding,
                               write_len=write_len if write else None)[1]
        elif not splash and not seq_parallel_active(cfg):
            mask = build_masks(cfg, L, doc_id, device=x.device)[1]
        wl = ((L if write_len is None else write_len) if write else None)
        remat = remat_active(cfg, kv_cache)

        def run(i, x):
            args = (x, cond, mask, splash, doc_id, pos_offset, kv_cache, wl)
            if remat:
                return checkpoint(self.blocks[i], *args, use_reentrant=False)
            return self.blocks[i](*args)

        n = cfg.n_layers
        mid = n // 2
        early = []
        for i in range(mid):
            x = run(i, x)
            early.append(x)
        x = run(mid, x)
        for i in range(mid + 1, n):
            x = self.skip_projs[i - mid - 1](x, early[n - 1 - i], cond)
            x = run(i, x)
        if write:
            kv_cache.advance(wl)
        return x
