"""Context (sequence) parallelism (counterpart of
owl_audio_exps_tpu/parallel/context.py): how dit_v4 trains at the
reference's 98,304-token context (configs/dit_v4_98k_sp.yml).

Each rank of the mesh's seq axis holds one contiguous slice of the
sequence, [idx * L_loc, (idx + 1) * L_loc), and runs every layer on it.
Attention is the only part that looks across slices:

* **Local window layers** see the trailing ``window`` frames, so a slice
  needs exactly one chunk (C = window * tokens_per_frame tokens) of its
  predecessor's K/V: a halo sent from rank idx to idx + 1, whose
  gradient the backward returns to its owner. On a CUDA tensor the layer
  runs a band kernel over [halo | slice] with C zero query rows in front,
  and drops their output (1 / (L_loc / C) more work than the slice
  alone); the first slice, which has no halo, runs the band over its own
  tokens. The band is the one the unsplit layer takes (``halo_band_route``):
  K2's port where the span is frame-exact (dit_v4), K5's with its plan
  elsewhere (the AV model's tpf 65). On a CPU tensor it runs ops/local.py
  ``chunked_local_attention`` with the halo.
* **Global causal layers** run ring attention. Step 0 attends the
  slice's own K/V under the frame-causal mask; each of the n - 1 further
  steps rotates K/V one rank along the ring (send to idx + 1, receive
  from idx - 1) and attends them without a mask. Each step's partial is
  K4 (ops/splash.py ``splash_attention_lse``: the normalized output and
  its logsumexp) on CUDA, its plain version on the CPU, and the partials
  merge exactly in float32 logsumexp form. K/V that came from a later
  slice (src >= idx) must not count: as in the JAX package the partial
  is still computed and its lse set to -inf at the merge, so every rank
  launches the same kernels. Steps 1 .. n - 1 are checkpointed (the
  partial is recomputed in the backward), as the JAX package's
  ``jax.checkpoint(step)``, so a global layer's forward launches n K4
  forwards and its backward n - 1 more, besides n dq and n dkv launches.

The rotation is a ``torch.autograd.Function`` whose backward is the
reverse rotation (the transpose of the JAX package's ``ppermute``); each
exchange is one ``batch_isend_irecv``, so neither side blocks on a send
before posting its receive. Every rank runs the same sequence of
exchanges, forward and backward, since each depends on the one before.
Document packing is not supported under context parallelism.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.band import band_attention
from ..ops.local import chunked_local_attention
from ..ops.splash import splash_attention_lse
from .dist import exchange as _exchange
from .mesh import Mesh, get_mesh


# ------------------------------------------------------------ exchanges

def _shift(tensors, mesh: Mesh, step: int):
    """Send each tensor to seq rank idx + step and return what arrives
    from idx - step (mod n)."""
    n, i, ranks = mesh.seq, mesh.seq_index, mesh.seq_ranks
    tensors = [t.contiguous() for t in tensors]
    out = [torch.empty_like(t) for t in tensors]
    _exchange([(t, ranks[(i + step) % n]) for t in tensors],
              [(o, ranks[(i - step) % n]) for o in out])
    return out


def _tangents(tangents, meta):
    """Forward-mode tangents, zeros where an input carries none."""
    return [torch.zeros(shape, dtype=dtype, device=dev) if g is None else g
            for g, (shape, dtype, dev) in zip(tangents, meta)]


class _Rotate(torch.autograd.Function):
    """Ring rotation: every rank's tensors move to the next seq rank; the
    backward moves their gradients back, and a forward-mode tangent
    (MeanFlow's jvp, models/gamemft_audio.py) moves with its tensor."""

    @staticmethod
    def forward(mesh, *tensors):
        return tuple(_shift(tensors, mesh, +1))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh = inputs[0]
        ctx.meta = [(t.shape, t.dtype, t.device) for t in inputs[1:]]

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_shift(grads, ctx.mesh, -1))

    @staticmethod
    def jvp(ctx, _, *tangents):
        return tuple(_shift(_tangents(tangents, ctx.meta), ctx.mesh, +1))


def _halo_exchange(mesh, C, k, v):
    n, i, ranks = mesh.seq, mesh.seq_index, mesh.seq_ranks
    tails = [t[:, :, -C:].contiguous() for t in (k, v)]
    halos = [torch.zeros_like(t) for t in tails]
    _exchange([(t, ranks[i + 1]) for t in tails] if i < n - 1 else [],
              [(h, ranks[i - 1]) for h in halos] if i > 0 else [])
    return halos


class _Halo(torch.autograd.Function):
    """Halo exchange of the last ``C`` tokens of k and v: rank idx sends
    them to idx + 1 and receives idx - 1's (zeros on the first rank).
    Returns (k, v, k_halo, v_halo): k and v pass through, so the node is
    on every rank's graph and its backward, which returns the halo's
    gradient to its owner, runs on every rank; a forward-mode tangent
    takes the same exchange."""

    @staticmethod
    def forward(mesh, C, k, v):
        kh, vh = _halo_exchange(mesh, C, k, v)
        return k.view_as(k), v.view_as(v), kh, vh

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh, ctx.C = inputs[0], inputs[1]
        ctx.meta = [(t.shape, t.dtype, t.device) for t in inputs[2:]]

    @staticmethod
    def jvp(ctx, _, __, tk, tv):
        tk, tv = _tangents((tk, tv), ctx.meta)
        kh, vh = _halo_exchange(ctx.mesh, ctx.C, tk, tv)
        return tk.view_as(tk), tv.view_as(tv), kh, vh

    @staticmethod
    def backward(ctx, gk, gv, gkh, gvh):
        mesh, C = ctx.mesh, ctx.C
        n, i, ranks = mesh.seq, mesh.seq_index, mesh.seq_ranks
        tail_grads = [g.new_zeros(g[:, :, -C:].shape) for g in (gk, gv)]
        halo_grads = [torch.zeros_like(t) if g is None else g.contiguous()
                      for g, t in zip((gkh, gvh), tail_grads)]
        _exchange([(g, ranks[i - 1]) for g in halo_grads] if i > 0 else [],
                  [(t, ranks[i + 1]) for t in tail_grads]
                  if i < n - 1 else [])
        gk, gv = gk.clone(), gv.clone()
        gk[:, :, -C:] += tail_grads[0]
        gv[:, :, -C:] += tail_grads[1]
        return None, None, gk, gv


# ------------------------------------------------------------- local

def local_attention_with_halo(q, k, v, k_halo, v_halo, tokens_per_frame: int,
                              window: int, halo_valid: bool,
                              logit_bound: Optional[float] = None):
    """One slice's local-window attention, given the C = window * tpf
    tokens of K/V before it (``halo_valid`` False: there are none, the
    first slice). CUDA: the band kernel over [halo | slice] (q padded
    with C zero rows whose output is dropped), or over the slice alone
    when the halo is not valid; CPU: ``chunked_local_attention``."""
    C = window * tokens_per_frame
    if q.device.type == "cpu":
        return chunked_local_attention(q, k, v, tokens_per_frame, window,
                                       halo_kv=(k_halo, v_halo),
                                       halo_valid=halo_valid)
    if not halo_valid:
        return halo_band(q, k, v, tokens_per_frame, window, logit_bound)
    q2 = torch.cat([torch.zeros_like(q[:, :, :C]), q], 2)
    k2 = torch.cat([k_halo.to(k.dtype), k], 2)
    v2 = torch.cat([v_halo.to(v.dtype), v], 2)
    return halo_band(q2, k2, v2, tokens_per_frame, window,
                     logit_bound)[:, :, C:]


def halo_band_route(n_tokens: int, tokens_per_frame: int, window: int):
    """The band kernel a slice's local layer takes over ``n_tokens``
    ([halo | slice] or the first slice), as the unsplit layer routes its
    ``auto`` band (nn/attn.py ``attention_route``): K2's port (ops/band.py)
    where the span is frame-exact (dit_v4's tpf 64), K5's (ops/band2.py)
    with ``best_plan``'s plan elsewhere (the AV model's tpf 65: (520, 2)
    at 26,000 and 24,960 tokens). Returns ("band", None) or ("band2",
    plan)."""
    from ..ops.band import use_frame_exact
    from ..ops.band2 import best_plan
    if not use_frame_exact(window * tokens_per_frame, tokens_per_frame):
        plan = best_plan(n_tokens, tokens_per_frame, window)
        if plan is not None:
            return "band2", plan
    return "band", None


def halo_band(q, k, v, tokens_per_frame: int, window: int,
              logit_bound: Optional[float] = None):
    """The causal band of ``window`` frames over q, k, v through the kernel
    ``halo_band_route`` names."""
    route, plan = halo_band_route(q.shape[2], tokens_per_frame, window)
    if route == "band2":
        from ..ops.band2 import band2_attention
        return band2_attention(q, k, v, tokens_per_frame, window, *plan,
                               logit_bound=logit_bound)
    return band_attention(q, k, v, tokens_per_frame, window,
                          logit_bound=logit_bound)


def sp_local_attention(q, k, v, tokens_per_frame: int, window: int,
                       mesh: Optional[Mesh] = None,
                       logit_bound: Optional[float] = None):
    """Halo-exchange local attention for this rank's [B, H, L_loc, Dh]
    slice. L_loc must be a multiple of C = window * tpf."""
    mesh = mesh or get_mesh()
    C = window * tokens_per_frame
    if q.shape[2] % C:
        raise ValueError(f"slice of {q.shape[2]} tokens is not a multiple "
                         f"of the window span {C}")
    k, v, kh, vh = _Halo.apply(mesh, C, k, v)
    return local_attention_with_halo(q, k, v, kh, vh, tokens_per_frame,
                                     window, mesh.seq_index > 0, logit_bound)


# ------------------------------------------------------------- global

def ring_partial(qs, k, v, tokens_per_frame: int, causal: bool):
    """One ring step's partial attention of pre-scaled ``qs`` over k, v:
    (out, lse), float32. K4 on CUDA, its plain version on the CPU."""
    if qs.shape[2] % tokens_per_frame:
        raise ValueError("sequence-parallel slices must be frame-aligned "
                         f"(L_loc={qs.shape[2]}, tpf={tokens_per_frame})")
    return splash_attention_lse(qs, k, v, tokens_per_frame, causal)


def ring_merge(out, lse, pout, plse, valid: bool):
    """Exact logsumexp merge of a partial (pout, plse) into (out, lse);
    an invalid partial (K/V of a later slice) gets lse -inf and so
    weight 0. ``lse`` stays finite (step 0 always sees its own frame)."""
    if not valid:
        plse = torch.full_like(plse, float("-inf"))
    m = torch.maximum(lse, plse)
    lse_new = m + torch.log(torch.exp(lse - m) + torch.exp(plse - m))
    out = (out * torch.exp(lse - lse_new)[..., None]
           + pout * torch.exp(plse - lse_new)[..., None])
    return out, lse_new


def _ring_step(qs, kr, vr, out, lse, tokens_per_frame, valid):
    pout, plse = ring_partial(qs, kr, vr, tokens_per_frame, False)
    return ring_merge(out, lse, pout, plse, valid)


def ring_step(qs, kr, vr, out, lse, tokens_per_frame: int, valid: bool):
    """Ring step r >= 1: the unmasked partial over the K/V that arrived,
    merged into (out, lse). Checkpointed when autograd records: its
    backward recomputes the partial (one more K4 forward); not inside a
    torch.func transform (MeanFlow's jvp), whose tensors the recompute
    would not see."""
    if torch.is_grad_enabled() and \
            not torch._C._are_functorch_transforms_active():
        return checkpoint(_ring_step, qs, kr, vr, out, lse, tokens_per_frame,
                          valid, use_reentrant=False)
    return _ring_step(qs, kr, vr, out, lse, tokens_per_frame, valid)


def sp_global_attention(q, k, v, tokens_per_frame: int,
                        mesh: Optional[Mesh] = None,
                        scale: Optional[float] = None):
    """Ring attention for this rank's [B, H, L_loc, Dh] slice of a
    frame-causal global layer; returns its [B, H, L_loc, Dh] output, equal
    to full-sequence causal attention restricted to its queries."""
    mesh = mesh or get_mesh()
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qs = (q * scale).to(q.dtype)
    n, idx = mesh.seq, mesh.seq_index
    out, lse = ring_partial(qs, k, v, tokens_per_frame, True)
    kr, vr = k, v
    for r in range(1, n):
        kr, vr = _Rotate.apply(mesh, kr, vr)
        src = (idx - r) % n      # the slice these K/V came from
        out, lse = ring_step(qs, kr, vr, out, lse, tokens_per_frame,
                             src < idx)
    return out.to(q.dtype)


# --------------------------------------------------------- dispatcher

def sp_attention(q, k, v, tokens_per_frame: int, window: Optional[int],
                 mesh: Optional[Mesh] = None,
                 logit_bound: Optional[float] = None):
    """Window -> halo exchange; full causal -> ring."""
    if window is not None:
        return sp_local_attention(q, k, v, tokens_per_frame, window, mesh,
                                  logit_bound)
    return sp_global_attention(q, k, v, tokens_per_frame, mesh)
