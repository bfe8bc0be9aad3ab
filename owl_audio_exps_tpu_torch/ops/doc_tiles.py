"""The document summary K1's kernels walk when ``doc_id`` is given.

K1 with documents (``ops/splash.py``) skips the tiles whose ids cannot
meet the block's, runs a tile of one document, the same on both sides,
unmasked where the frame mask calls it full, clips its walk to its
documents' runs, and takes its tile in an order by work. It reads all of
that from a per-call summary of the per-frame ``doc_id`` that the helper
kernel of ``csrc/frame_attention.cu`` (``owl_doc_tiles``) writes on the
card, so no step reads the ids on the host. Its layout, per batch row of
``doc_tiles_row(L, tpf)`` int32 (``csrc/hopper_attention.cuh``, section
"documents"):

  tiles [n64, 4]   per 64-row tile (its rows below L): the least and the
                   greatest id, and the first and last frame its rows can
                   see by document (their runs' bounds where the row's ids
                   never decrease, else 0 and n_frames - 1);
  runs [n_frames, 2]  each frame's run of equal ids, first and last frame
                   (0 and n_frames - 1 where the ids decrease somewhere);
  order_q, order_k [n128]  the 128-row tiles as query tiles (forward, dq)
                   and as key tiles (dkv), by decreasing work (the length
                   of the clipped range), ties by tile;
  mono             1 where the row's ids never decrease;

and zeros to a multiple of 4. Where the ids never decrease an id fills one
run, so a row's visible keys are one interval of frames; where they
decrease, the same id may fill two runs that see each other (JAX's
``SegmentIds`` compare ids, not runs), so nothing is clipped and the
masked tiles compare the ids.

``doc_tiles`` is the plain PyTorch version of the helper, int for int;
``doc_tiles_cuda`` launches the helper (counted in ``launches``).
``doc_walk`` and ``doc_row_mask`` are plain versions of what the kernels
do with the summary (the classification, the clip and the per-element
test of a masked tile), for the tests to hold against ``dense_mask``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

launches = 0   # owl_doc_tiles launches since the last reset

# the longest L K1 takes with documents (csrc/hopper_attention.cuh
# kDocMaxL: the walks' bits in shared memory)
DOC_MAX_L = 1 << 19
ROWS = 128     # a block's own tile (kRows)


def tile_counts(L: int, tokens_per_frame: int):
    """(n_frames, 64-row tiles, 128-row tiles) along L."""
    return -(-L // tokens_per_frame), -(-L // 64), -(-L // ROWS)


def doc_tiles_row(L: int, tokens_per_frame: int) -> int:
    """int32 entries of one batch row's summary."""
    nf, n64, n128 = tile_counts(L, tokens_per_frame)
    return (4 * n64 + 2 * nf + 2 * n128 + 1 + 3) // 4 * 4


def _key_frames(nf, tpf, L, window, causal, own0, rows, first, last):
    """Frames [lo, hi] of the keys query rows [own0, own0 + rows) can see
    (kv_range_doc), elementwise over tensors own0, first, last."""
    w = window or 0
    fq_lo, fq_hi = own0 // tpf, (torch.clamp(own0 + rows, max=L) - 1) // tpf
    lo = torch.clamp(fq_lo - w + 1, min=0) if w > 0 else torch.zeros_like(
        fq_lo)
    hi = fq_hi if causal else (torch.clamp(fq_hi + w - 1, max=nf - 1)
                               if w > 0 else torch.full_like(fq_hi, nf - 1))
    return torch.maximum(lo, first), torch.minimum(hi, last)


def _query_frames(nf, tpf, L, window, causal, own0, rows, first, last):
    """Frames [lo, hi] of the queries that can see key rows [own0, own0 +
    rows) (q_range_doc)."""
    w = window or 0
    fk_lo, fk_hi = own0 // tpf, (torch.clamp(own0 + rows, max=L) - 1) // tpf
    lo = fk_lo if causal else (torch.clamp(fk_lo - w + 1, min=0)
                               if w > 0 else torch.zeros_like(fk_lo))
    hi = torch.clamp(fk_hi + w - 1, max=nf - 1) if w > 0 else \
        torch.full_like(fk_hi, nf - 1)
    return torch.maximum(lo, first), torch.minimum(hi, last)


def _rows_of(lo, hi, tpf, L, align):
    """[begin, end) rows of frames [lo, hi], begin aligned down to
    ``align``."""
    return (lo * tpf) // align * align, torch.clamp((hi + 1) * tpf, max=L)


def doc_tiles(doc_id, L: int, tokens_per_frame: int,
              window: Optional[int], causal: bool) -> torch.Tensor:
    """The summary of per-frame ``doc_id`` [B, n_frames] for K1 at (L,
    tokens_per_frame, window, causal): int32 [B, doc_tiles_row(L, tpf)],
    the plain version of the owl_doc_tiles kernel (the same ints)."""
    tpf = tokens_per_frame
    doc = torch.as_tensor(doc_id).to(torch.int64)
    B, nf = doc.shape
    _, n64, n128 = tile_counts(L, tpf)
    if nf != tile_counts(L, tpf)[0]:
        raise ValueError(f"doc_id has {nf} frames, L {L} at tpf {tpf} has "
                         f"{tile_counts(L, tpf)[0]}")
    dev = doc.device
    mono = (doc[:, 1:] >= doc[:, :-1]).all(1, keepdim=True)
    last_frame = torch.full_like(doc, nf - 1)
    # on a row whose ids never decrease, a run is the ids' sorted range
    runs = torch.stack([
        torch.where(mono, torch.searchsorted(doc, doc), 0),
        torch.where(mono, torch.searchsorted(doc, doc, right=True) - 1,
                    last_frame)], -1)

    # the rows' ids by 64-row tile, rows past L repeating row L - 1
    rows = torch.clamp(torch.arange(n64 * 64, device=dev), max=L - 1)
    ids = doc[:, rows // tpf].view(B, n64, 64)
    lo, hi = ids.amin(-1), ids.amax(-1)
    first = torch.where(mono, torch.searchsorted(doc, lo), 0)
    last = torch.where(mono, torch.searchsorted(doc, hi, right=True) - 1,
                       nf - 1)
    tiles = torch.stack([lo, hi, first, last], -1)       # [B, n64, 4]

    # the 128-row tiles' work: their clipped ranges' lengths
    t0 = torch.arange(n128, device=dev) * ROWS
    a, z = torch.arange(n128, device=dev) * 2, torch.clamp(
        torch.arange(n128, device=dev) * 2 + 1, max=n64 - 1)
    f128 = torch.minimum(first[:, a], first[:, z])
    l128 = torch.maximum(last[:, a], last[:, z])
    work = []
    for frames in (_key_frames, _query_frames):
        flo, fhi = frames(nf, tpf, L, window, causal, t0, ROWS, f128, l128)
        begin, end = _rows_of(flo, fhi, tpf, L, 1)
        work.append(end - begin)
    orders = [torch.sort(w, dim=1, descending=True, stable=True).indices
              for w in work]

    parts = [tiles.reshape(B, -1), runs.reshape(B, -1), *orders,
             mono.to(torch.int64)]
    out = torch.cat(parts, 1)
    row = doc_tiles_row(L, tpf)
    out = torch.nn.functional.pad(out, (0, row - out.shape[1]))
    return out.to(torch.int32)


def doc_tile_parts(summary: torch.Tensor, L: int, tokens_per_frame: int):
    """The named parts of a summary [B, doc_tiles_row]: tiles [B, n64, 4],
    runs [B, n_frames, 2], order_q and order_k [B, n128], mono [B]."""
    nf, n64, n128 = tile_counts(L, tokens_per_frame)
    s = summary.long()
    o = 4 * n64 + 2 * nf
    return dict(tiles=s[:, :4 * n64].view(-1, n64, 4),
                runs=s[:, 4 * n64:o].view(-1, nf, 2),
                order_q=s[:, o:o + n128], order_k=s[:, o + n128:o + 2 * n128],
                mono=s[:, o + 2 * n128])


@functools.lru_cache(maxsize=None)
def _entry():
    from . import _build
    fn = _build.load("frame_attention").owl_doc_tiles
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def doc_tiles_cuda(doc: torch.Tensor, L: int, tokens_per_frame: int,
                   window: Optional[int], causal: bool) -> torch.Tensor:
    """Launch owl_doc_tiles on a contiguous int32 ``doc`` [B, n_frames] on
    the card: the summary, int32 [B, doc_tiles_row(L, tpf)], written on the
    current stream with no host read of the ids."""
    global launches
    B, nf = doc.shape
    if doc.device.type != "cuda" or doc.dtype != torch.int32 or \
            not doc.is_contiguous():
        raise ValueError("doc_tiles_cuda takes a contiguous int32 CUDA "
                         "tensor")
    if nf != tile_counts(L, tokens_per_frame)[0]:
        raise ValueError(f"doc_id has {nf} frames, L {L} at tpf "
                         f"{tokens_per_frame} has "
                         f"{tile_counts(L, tokens_per_frame)[0]}")
    if L > DOC_MAX_L:
        raise ValueError(f"K1 with documents takes L <= {DOC_MAX_L}, got {L}")
    out = torch.empty(B, doc_tiles_row(L, tokens_per_frame),
                      dtype=torch.int32, device=doc.device)
    ptrs = (ctypes.c_void_p * 2)(doc.data_ptr(), out.data_ptr())
    ints = (ctypes.c_int * 5)(B, L, tokens_per_frame, window or 0,
                              int(bool(causal)))
    err = _entry()(ptrs, ints,
                   torch.cuda.current_stream(doc.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"document summary kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out


# ------------------------------------------- what the kernels do with it

def _tile_full(L, tpf, window, causal, q0, nq, k0, nk) -> bool:
    """csrc/hopper_attention.cuh tile_full: every pair of query rows [q0,
    q0 + nq) and key rows [k0, k0 + nk) visible by the frame mask."""
    if q0 + nq > L or k0 + nk > L:
        return False
    fq_lo, fq_hi = q0 // tpf, (q0 + nq - 1) // tpf
    fk_lo, fk_hi = k0 // tpf, (k0 + nk - 1) // tpf
    if causal and fk_hi > fq_lo:
        return False
    if window and (fq_hi - fk_lo >= window or fk_hi - fq_lo >= window):
        return False
    return True


def _span(tiles, n64, r0, rows):
    """(lo, hi, first, last) of rows [r0, r0 + rows) (doc_span)."""
    t = tiles[r0 // 64:min((r0 + rows) // 64, n64)]
    return (int(t[:, 0].min()), int(t[:, 1].max()), int(t[:, 2].min()),
            int(t[:, 3].max()))


def doc_walk(summary, L: int, tokens_per_frame: int, window: Optional[int],
             causal: bool, b: int, own0: int, keys_own: bool,
             other_rows: int):
    """What one kernel block does with the summary (doc_walk_build and the
    clip): for the 128-row tile at ``own0`` of batch row ``b`` (query rows;
    key rows with ``keys_own``, the dkv kernel) against tiles of
    ``other_rows`` of the other operand (the forward 128, dq and dkv 64),
    (begin, end, [(first row, visited, full for rows own0 + [0, 64), full
    for own0 + [64, 128))]) over the tiles of the clipped range [begin,
    end)."""
    tpf, nf = tokens_per_frame, tile_counts(L, tokens_per_frame)[0]
    n64 = tile_counts(L, tpf)[1]
    tiles = doc_tile_parts(summary, L, tpf)["tiles"][b]
    own = _span(tiles, n64, own0, ROWS)
    frames = _query_frames if keys_own else _key_frames
    flo, fhi = frames(nf, tpf, L, window, causal, torch.tensor(own0), ROWS,
                      torch.tensor(own[2]), torch.tensor(own[3]))
    begin, end = (int(x) for x in _rows_of(flo, fhi, tpf, L, other_rows))
    halves = [_span(tiles, n64, own0 + 64 * c, 64) if own0 + 64 * c < L
              else None for c in range(2)]
    walk = []
    for o0 in range(begin, end, other_rows):
        o = _span(tiles, n64, o0, other_rows)
        vis = o[0] <= own[1] and own[0] <= o[1]
        full = []
        for c, h in enumerate(halves):
            r = own0 + 64 * c
            frame_full = (_tile_full(L, tpf, window, causal, o0, other_rows,
                                     r, 64) if keys_own else
                          _tile_full(L, tpf, window, causal, r, 64, o0,
                                     other_rows))
            full.append(vis and o[0] == o[1] and h is not None
                        and h[0] == h[1] == o[0] and frame_full)
        walk.append((o0, vis, *full))
    return begin, end, walk


def doc_row_mask(summary, doc_id, L: int, tokens_per_frame: int,
                 window: Optional[int], causal: bool,
                 keys_own: bool = False) -> torch.Tensor:
    """The per-element test of a masked tile (row_iv, row_sees) for every
    pair: bool [B, L, L], [query, key] (``keys_own``: [key, query], the
    dkv kernel's rows). Each row's frames form one interval, its frame mask
    narrowed to its run; where the ids decrease the ids are compared too.
    """
    tpf = tokens_per_frame
    nf = tile_counts(L, tpf)[0]
    parts = doc_tile_parts(summary, L, tpf)
    doc = torch.as_tensor(doc_id).long()
    wl = min(window, nf) if window else nf
    f = torch.arange(L) // tpf
    runs = parts["runs"][:, f]                          # [B, L, 2]
    if keys_own:
        lo, hi = (f if causal else f - wl + 1), f + wl - 1
    else:
        lo, hi = f - wl + 1, (f if causal else f + wl - 1)
    lo = torch.maximum(lo, runs[..., 0])[..., None]
    hi = torch.minimum(hi, runs[..., 1])[..., None]
    other = f[None, None, :]
    same = doc[:, f][:, :, None] == doc[:, f][:, None, :]
    mono = parts["mono"].bool()[:, None, None]
    return (lo <= other) & (other <= hi) & (mono | same)
