"""Decode attention: a few new query tokens over [ring | new tokens], the
ring read in place (csrc/decode_attention.cu).

The cached forward (nn/attn.py ``cached_attention``) hands each layer's
ring K/V (``KVCache.read_layer``, or ``gather_trailing`` for a decoding
local layer) and the new tokens' K/V as two sources, with the bool mask
it builds over [slots | new], [lq, S + t] or [b, lq, S + t]. The
numerics are ops/attention.py's contract: float32 logits from the stored
bf16 (or fp16) operands, a float32 softmax over every visible key of
both sources, probabilities normalised and then rounded to V's dtype,
P.V accumulated in float32, the output in q's dtype. The JAX package has
no kernel here (it deleted its flash-decode kernel); this one replaces
the port's plain float32 path on the card.

The algorithm (``decode_attention_plain`` is its plain version):

* query rows in tiles of at most ``MAX_ROWS`` (``query_tiling``; 65 rows
  take 80, 130 take 144), keys in 64-key tiles, the ring's
  ceil(S / 64) first and then the new tokens' ceil(t / 64)
  (``key_tiles``);
* a tile whose mask block is all false for a query tile is skipped: its
  K/V is never read, so it contributes nothing;
* the visible tiles, in order, are dealt to ``ns`` splits (``split_count``,
  ``split_range`` over their count), one block each, to fill the card;
* pass 1 gives each split's (max, sum) a row; pass 2 combines them in
  split order, and each split forms the normalised P over its tiles and
  its part of P.V; the splits' parts are summed in split order.

On a CUDA tensor ``decode_attention`` launches the kernels (the plan that
turns the mask into words and tile flags, pass 1, pass 2 and, with more
than one split, the sum; counted in ``launches``); on a
CPU tensor it runs the plain version. There is no other route: a call the
kernel cannot take raises (``refusal`` says why). The router asks
``accepts`` once and then launches ``decode_attention_cuda``. A row that
sees no key gives zeros (dot_attention would average every value under
its finfo.min fill); the cached forward's masks always show a query its
own frame.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

launches = 0      # kernel launches since the last reset (set to 0 to reset)

KEYS = 64         # keys a tile (csrc kKeys)
MAX_ROWS = 160    # query rows a block (16 * kMaxWarps)
H100_SMS = 132    # the plain version splits as on the H100
HEAD_DIMS = (64, 128)
DTYPES = (torch.bfloat16, torch.float16)
ALIGN = 16        # bytes: cp.async reads 16-byte chunks of a row
MAX_TILES = 1 << 14  # the kernel's tile list in shared memory (kMaxTiles)


def query_tiling(lq: int):
    """(rows a block, query tiles): the fewest tiles of at most
    ``MAX_ROWS`` rows, each a multiple of 16 rows."""
    nq = -(-lq // MAX_ROWS)
    return -(-(-(-lq // nq)) // 16) * 16, nq


def key_tiles(S: int, t: int):
    """(ring tiles, all tiles): ceil(S / 64) ring tiles, then ceil(t / 64)
    tiles of the new tokens; tile j's keys are the mask's columns
    ``tile_columns(j)``."""
    nr = -(-S // KEYS)
    return nr, nr + -(-t // KEYS)


def tile_columns(j: int, S: int, t: int):
    """The mask columns [c0, c1) of tile j over [ring | new]."""
    nr = -(-S // KEYS)
    if j < nr:
        return j * KEYS, min((j + 1) * KEYS, S)
    k0 = (j - nr) * KEYS
    return S + k0, S + min(k0 + KEYS, t)


def split_count(units: int, T: int, sms: int = H100_SMS) -> int:
    """Splits of the key tiles: about two blocks an SM over ``units`` =
    batch x heads x query tiles blocks a split, at most one tile a split."""
    return max(1, min(T, -(-2 * sms // units)))


def split_range(s: int, ns: int, nv: int):
    """Split s's share [lo, hi) of the nv visible tiles."""
    return s * nv // ns, (s + 1) * nv // ns


def _mask3(mask: torch.Tensor, lq: int, n: int) -> torch.Tensor:
    """``mask`` as a [1 or B, lq, n] view (broadcast dims expanded, no
    copy)."""
    m = mask if mask.ndim == 3 else mask[None]
    return m.expand(m.shape[0], lq, n)


def refusal(q, ck, cv, nk, nv, mask) -> Optional[str]:
    """Why ``decode_attention`` cannot take this call, or None. q: [B, H,
    lq, Dh]; ck, cv: [B, H, S, Dh]; nk, nv: [B, H, t, Dh]; mask: bool,
    broadcastable to [B, lq, S + t] with 2 or 3 dims."""
    ts = dict(q=q, ck=ck, cv=cv, nk=nk, nv=nv)
    if any(x.ndim != 4 for x in ts.values()):
        return "q, ck, cv, nk, nv must be [B, H, L, Dh]"
    B, H, lq, Dh = q.shape
    S, t = ck.shape[2], nk.shape[2]
    if Dh not in HEAD_DIMS:
        return f"head dim {Dh}: the kernel takes {HEAD_DIMS}"
    if q.dtype not in DTYPES or any(x.dtype != q.dtype for x in ts.values()):
        return (f"q, ck, cv, nk, nv must share one of {DTYPES}, got "
                f"{[str(x.dtype) for x in ts.values()]}")
    for name, x, n in (("ck", ck, S), ("cv", cv, S), ("nk", nk, t),
                       ("nv", nv, t)):
        if tuple(x.shape) != (B, H, n, Dh):
            return f"{name} shape {tuple(x.shape)} != {(B, H, n, Dh)}"
    if lq < 1 or t < 1:
        return "no query or new token"
    if key_tiles(S, t)[1] > MAX_TILES:
        return f"S + t = {S + t}: the kernel takes at most {MAX_TILES} tiles"
    if (not isinstance(mask, torch.Tensor) or mask.dtype != torch.bool
            or mask.ndim not in (2, 3)):
        return "mask must be bool [lq, S + t] or [b, lq, S + t]"
    try:
        torch.broadcast_shapes(tuple(mask.shape), (B, lq, S + t))
    except RuntimeError:
        return (f"mask {tuple(mask.shape)} does not broadcast to "
                f"{(B, lq, S + t)}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in ts.values()):
        return "a gradient is required: the decode kernel has no backward"
    if torch._C._are_functorch_transforms_active():
        return "inside a torch.func transform"
    devs = {x.device for x in ts.values()} | {mask.device}
    if len(devs) != 1:
        return f"tensors on several devices: {devs}"
    if q.device.type == "cuda":
        if B * H > 65535:
            return f"B * H = {B * H} exceeds the grid's 65535"
        esz = q.element_size()
        for name, x in ts.items():
            if x.stride(3) != 1:
                return f"{name}: the head dim must be contiguous"
            if x.data_ptr() % ALIGN or any(
                    (st * esz) % ALIGN for st in x.stride()[:3]):
                return (f"{name}: base and strides must be {ALIGN}-byte "
                        f"aligned, got strides {x.stride()}")
    elif q.device.type != "cpu":
        return f"no decode attention for device {q.device}"
    return None


def accepts(q, ck, cv, nk, nv, mask) -> bool:
    """Whether a cached forward's call takes the kernel: CUDA tensors the
    kernel can read (``refusal``)."""
    return q.device.type == "cuda" and refusal(q, ck, cv, nk, nv,
                                               mask) is None


def decode_attention(q, ck, cv, nk, nv, mask) -> torch.Tensor:
    """Attention of q [B, H, lq, Dh] over [ck | nk] with values [cv | nv]
    under ``mask`` (bool, [lq, S + t] or [b, lq, S + t], ring columns
    first), scale Dh^-0.5. Returns [B, H, lq, Dh] in q's dtype: the kernel
    on a CUDA tensor, the plain version on a CPU tensor; raises ValueError
    on a call the kernel cannot take."""
    why = refusal(q, ck, cv, nk, nv, mask)
    if why is not None:
        raise ValueError(f"decode_attention: {why}")
    if q.device.type == "cpu":
        return decode_attention_plain(q, ck, cv, nk, nv, mask)
    return decode_attention_cuda(q, ck, cv, nk, nv, mask)


@functools.lru_cache(maxsize=None)
def _entry():
    from . import _build
    fn = _build.load("decode_attention").owl_decode_attn
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_longlong),
                   ctypes.POINTER(ctypes.c_int), ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention_cuda(q, ck, cv, nk, nv, mask) -> torch.Tensor:
    """Launch the kernels on the current stream (no host sync, no read of
    the ring's counters: graph-capturable); the scratch comes from
    torch.empty."""
    global launches
    B, H, lq, Dh = q.shape
    S, t = ck.shape[2], nk.shape[2]
    rows, nq = query_tiling(lq)
    _, T = key_tiles(S, t)
    ns = split_count(B * H * nq, T, _sms(q.device.index or 0))
    m = _mask3(mask, lq, S + t)
    bm = m.shape[0]
    dev = q.device
    bits = torch.empty(bm * nq * T * rows, dtype=torch.int64, device=dev)
    flags = torch.empty(bm * nq * T, dtype=torch.uint8, device=dev)
    # [B, lq, H, Dh] storage: the caller's transpose back is free
    out = torch.empty(B, lq, H, Dh, dtype=q.dtype, device=dev).transpose(1, 2)
    ml = torch.empty(B * H * nq * ns * rows * 2, dtype=torch.float32,
                     device=dev)
    po = (torch.empty(B * H * nq * ns * rows * Dh, dtype=torch.float32,
                      device=dev) if ns > 1 else None)
    ptrs = [q.data_ptr(), ck.data_ptr(), cv.data_ptr(), nk.data_ptr(),
            nv.data_ptr(), m.data_ptr(), out.data_ptr(), ml.data_ptr(),
            None if po is None else po.data_ptr(), bits.data_ptr(),
            flags.data_ptr()]
    strides = []
    for x in (q, ck, cv, nk, nv, out):
        strides.extend(x.stride()[:3])
    strides.extend([m.stride(0) if bm > 1 else 0, m.stride(1), m.stride(2)])
    ints = [B, H, lq, S, t, Dh, int(q.dtype == torch.float16), rows, nq, ns,
            int(bm > 1)]
    with torch.cuda.device(dev):
        err = _entry()((ctypes.c_void_p * 11)(*ptrs),
                       (ctypes.c_longlong * 21)(*strides),
                       (ctypes.c_int * 11)(*ints),
                       Dh ** -0.5,
                       torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 3 + (ns > 1)
    return out


def decode_attention_plain(q, ck, cv, nk, nv, mask) -> torch.Tensor:
    """The kernel's algorithm in plain PyTorch, float32 arithmetic on the
    operands as given: per mask batch row and query tile, the visible key
    tiles in order (all-false tiles skipped, their K/V never read), dealt
    to ``split_count`` splits at the H100's 132 SMs; pass 1's (max, sum) a
    split; pass 2's normalised P, rounded to V's dtype, times V a split;
    the splits summed in split order."""
    B, H, lq, _ = q.shape
    ns = split_count(B * H * query_tiling(lq)[1],
                     key_tiles(ck.shape[2], nk.shape[2])[1])
    return _plain(q, ck, cv, nk, nv, mask, ns)


def _plain(q, ck, cv, nk, nv, mask, ns: int,
           partials: Optional[list] = None) -> torch.Tensor:
    """``decode_attention_plain`` at ``ns`` splits. ``partials``, when
    given, receives each (mask batch row, query tile)'s split outputs,
    float32, in split order."""
    B, H, lq, Dh = q.shape
    S, t = ck.shape[2], nk.shape[2]
    scale = Dh ** -0.5
    rows, nq = query_tiling(lq)
    _, T = key_tiles(S, t)
    m3 = _mask3(mask, lq, S + t)
    kf = torch.cat([ck, nk], dim=2)
    vf = torch.cat([cv, nv], dim=2)
    cols = [tile_columns(j, S, t) for j in range(T)]
    out = torch.zeros(B, H, lq, Dh, dtype=torch.float32, device=q.device)
    # the batch rows that share a mask row
    groups = ([(0, slice(0, B))] if m3.shape[0] == 1 else
              [(b, slice(b, b + 1)) for b in range(B)])
    for bm, bs in groups:
        for qt in range(nq):
            r0, r1 = qt * rows, min(lq, (qt + 1) * rows)
            mq = m3[bm, r0:r1]
            visible = [j for j in range(T)
                       if bool(mq[:, cols[j][0]:cols[j][1]].any())]
            runs = []
            for s in range(ns):
                lo, hi = split_range(s, ns, len(visible))
                idx = [c for j in visible[lo:hi] for c in range(*cols[j])]
                if not idx:
                    runs.append(None)
                    continue
                ix = torch.tensor(idx, device=q.device)
                logits = torch.matmul(
                    q[bs, :, r0:r1].float(),
                    kf[bs].index_select(2, ix).float().transpose(-1, -2))
                vis = mq[:, ix][None, None]
                logits = torch.where(vis, logits * scale, -math.inf)
                mx = logits.amax(-1)
                e = torch.exp(logits - torch.where(
                    torch.isinf(mx), 0.0, mx)[..., None])
                runs.append((logits, vf[bs].index_select(2, ix), mx,
                             e.sum(-1)))
            done = [r for r in runs if r is not None]
            if not done:
                continue
            # pass 2: the rows' max and sum over the splits, in split order
            mx = done[0][2]
            for r in done[1:]:
                mx = torch.maximum(mx, r[2])
            m0 = torch.where(torch.isinf(mx), 0.0, mx)
            lsum = torch.zeros_like(mx)
            for r in done:
                lsum = lsum + torch.where(r[3] > 0,
                                          r[3] * torch.exp(r[2] - m0), 0.0)
            inv = torch.where(lsum > 0, 1.0 / lsum, 0.0)[..., None]
            parts = []
            for r in runs:
                if r is None:
                    parts.append(None)
                    continue
                logits, vj = r[0], r[1]
                p = torch.exp(logits - m0[..., None]) * inv
                parts.append(torch.matmul(p.to(vj.dtype).float(),
                                          vj.float()))
            acc = None
            for o in parts:   # split order
                if o is not None:
                    acc = o if acc is None else acc + o
            if partials is not None:
                partials.append(parts)
            out[bs, :, r0:r1] = acc
    return out.to(q.dtype)
