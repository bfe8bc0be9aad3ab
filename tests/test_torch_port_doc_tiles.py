"""The document summary K1's kernels walk (owl_audio_exps_tpu_torch/ops/
doc_tiles.py): its plain version, and the plain classification, clip and
per-element test the kernels make of it, held against the mask itself
(``dense_mask``, the port's spec of JAX's splash with ``SegmentIds``).

The kernels run only on a card: chip_smoke.py holds the helper kernel's
summary against ``doc_tiles`` int for int there, and K1 with documents
against its plain version.
"""

import itertools

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from owl_audio_exps_tpu_torch.ops import doc_tiles as dt
from owl_audio_exps_tpu_torch.ops import splash
from owl_audio_exps_tpu_torch.ops.masks import dense_mask

# (other rows, keys own) of each kernel's walk: the forward's
# 128-row key tiles, dq's 64-row key tiles, dkv's 64-row query tiles
GEOMETRIES = {"fwd": (128, False), "dq": (64, False), "dkv": (64, True)}


def layout(kind: str, n_frames: int, rng: np.random.RandomState):
    """Per-frame ids of one kind: ids that never decrease, ids that only
    decrease, or runs where one id comes back after another."""
    if kind == "repeated":
        cuts = np.sort(rng.choice(np.arange(1, n_frames), size=min(
            n_frames - 1, rng.randint(2, 5)), replace=False))
        runs = np.split(np.arange(n_frames), cuts)
        ids = [(7, 3)[i % 2] for i in range(len(runs))]   # 7, 3, 7, ...
        return np.concatenate([np.full(len(r), d) for r, d in zip(runs,
                                                                   ids)])
    ids = np.sort(rng.randint(0, 6, size=n_frames))
    return ids[::-1].copy() if kind == "decreasing" else ids


def check_walks(doc, L, tpf, window, causal):
    """Every block of every kernel: a skipped tile holds no visible pair,
    a FULL tile (per 64-row half of the block's own tile) only visible
    pairs, and the clipped range every visible pair of the block's rows;
    the per-element test of a masked tile is the mask itself. Returns
    (skipped, full) tiles seen."""
    summary = dt.doc_tiles(doc, L, tpf, window, causal)
    mask = dense_mask(L, tpf, window, doc.long(), 0, causal)   # [B, q, k]
    for keys_own in (False, True):
        want = mask.transpose(1, 2) if keys_own else mask
        assert torch.equal(dt.doc_row_mask(summary, doc, L, tpf, window,
                                           causal, keys_own), want)
    skipped = full = 0
    for b in range(doc.shape[0]):
        for name, (other, keys_own) in GEOMETRIES.items():
            m = mask[b].T if keys_own else mask[b]     # [own rows, other]
            for own0 in range(0, L, 128):
                rows = m[own0:own0 + 128]
                begin, end, walk = dt.doc_walk(summary, L, tpf, window,
                                               causal, b, own0, keys_own,
                                               other)
                seen = rows.any(0).nonzero().flatten()
                assert len(seen), (name, own0)   # a row sees itself
                assert begin <= seen.min() and seen.max() < end, \
                    (name, own0, begin, end)
                assert begin % other == 0
                assert sum(v for _, v, *_ in walk) >= 1
                for o0, vis, *halves in walk:
                    tile = rows[:, o0:o0 + other]
                    if not vis:
                        skipped += 1
                        assert not tile.any(), (name, own0, o0)
                    for c, is_full in enumerate(halves):
                        if is_full:
                            full += 1
                            part = tile[64 * c:64 * c + 64]
                            assert part.shape == (64, other), (name, own0)
                            assert part.all(), (name, own0, o0, c)
    return skipped, full


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(kinds=st.tuples(*[st.sampled_from(
           ("nondecreasing", "decreasing", "repeated"))] * 2),
       tpf=st.sampled_from((64, 65, 13)),
       n_frames=st.integers(2, 24),
       ragged=st.integers(0, 12),
       window=st.sampled_from((None, 16, 3)),
       causal=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_walk_of_the_plain_summary_holds_the_mask(kinds, tpf, n_frames,
                                                  ragged, window, causal,
                                                  seed):
    """128-row tiles over two batch rows of any two layouts, the last
    frame cut short (rows past L), boundaries in mid-tile at tpf 65 and
    13, windows and none, causal and bidirectional."""
    rng = np.random.RandomState(seed)
    L = n_frames * tpf - min(ragged, tpf - 1)
    doc = torch.from_numpy(np.stack([layout(k, n_frames, rng)
                                     for k in kinds]).astype(np.int32))
    check_walks(doc, L, tpf, window, causal)


@pytest.mark.parametrize("window,causal", list(itertools.product(
    (None, 16), (True, False))))
def test_packed_layouts_skip_and_run_full_tiles(window, causal):
    """The loader's layout (ids that never decrease) at tpf 64, documents
    of 2-9 frames with boundaries on tile edges and in mid-tile, beside
    ids that decrease and come back: the walk runs FULL tiles, skips
    (where ids decrease; the clip leaves nothing to skip where they never
    do), and holds the mask."""
    doc = torch.tensor([[0] * 4 + [1] * 3 + [2] * 9 + [3] * 6 + [4] * 2,
                        [5] * 6 + [4] * 6 + [5] * 6 + [1] * 6])
    skipped, full = check_walks(doc.int(), 24 * 64, 64, window, causal)
    assert full > 0 and skipped > 0


def test_summary_of_a_known_layout():
    """ids 0, 0, 0, 1, 1, 2 at tpf 64 (L 384): the tiles' ids and runs,
    and the 128-row tiles in order of work (causal, no window: query
    tiles see keys of frames [0, 1], [0, 3], [3, 5]; key tiles are seen
    by queries of frames [0, 2], [2, 4], [4, 5])."""
    doc = torch.tensor([[0, 0, 0, 1, 1, 2]], dtype=torch.int32)
    s = dt.doc_tiles(doc, 384, 64, None, True)
    assert s.dtype == torch.int32 and s.shape == (1, dt.doc_tiles_row(384,
                                                                      64))
    parts = dt.doc_tile_parts(s, 384, 64)
    assert parts["tiles"][0].tolist() == [
        [0, 0, 0, 2], [0, 0, 0, 2], [0, 0, 0, 2], [1, 1, 3, 4],
        [1, 1, 3, 4], [2, 2, 5, 5]]
    assert parts["runs"][0].tolist() == [[0, 2]] * 3 + [[3, 4]] * 2 + [
        [5, 5]]
    assert parts["order_q"][0].tolist() == [1, 2, 0]     # 256, 192, 128
    assert parts["order_k"][0].tolist() == [0, 1, 2]     # 192, 192, 128
    assert parts["mono"].tolist() == [1]
    assert s[0, 4 * 6 + 2 * 6 + 2 * 3 + 1:].abs().sum() == 0   # padding


def test_decreasing_ids_keep_the_whole_row():
    """Where the ids decrease an id may fill two runs, which see each
    other: no run bounds, no clip; the ids' interval still skips."""
    doc = torch.tensor([[1, 1, 0, 0, 1, 2]], dtype=torch.int32)
    parts = dt.doc_tile_parts(dt.doc_tiles(doc, 384, 64, None, False), 384,
                              64)
    assert parts["mono"].tolist() == [0]
    assert parts["runs"][0].tolist() == [[0, 5]] * 6
    assert parts["tiles"][0, :, 2:].tolist() == [[0, 5]] * 6
    assert parts["tiles"][0, :, :2].tolist() == [
        [1, 1], [1, 1], [0, 0], [0, 0], [1, 1], [2, 2]]


def test_order_is_a_permutation_by_work():
    rng = np.random.RandomState(3)
    doc = torch.from_numpy(np.sort(rng.randint(0, 9, (3, 200)), 1)).int()
    for window, causal in itertools.product((None, 16), (True, False)):
        parts = dt.doc_tile_parts(dt.doc_tiles(doc, 200 * 65 - 7, 65,
                                               window, causal),
                                  200 * 65 - 7, 65)
        for key in ("order_q", "order_k"):
            for row in parts[key]:
                assert sorted(row.tolist()) == list(range(len(row)))


def test_plain_splash_takes_a_doc_tiles():
    """The entry points take a DocTiles in place of doc_id (the backward
    reuses its forward's); the plain version reads its ids."""
    rs = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rs.randn(1, 2, 130, 64).astype(np.float32))
               for _ in range(3))
    doc = torch.tensor([[0, 0, 1, 1, 0, 0, 1, 1, 1, 2]], dtype=torch.int32)
    docs = splash.DocTiles(doc, dt.doc_tiles(doc, 130, 13, 3, True),
                           (130, 13, 3, True))
    got = splash.splash_attention_plain(q, k, v, 13, 3, True, docs)
    want = splash.splash_attention_plain(q, k, v, 13, 3, True, doc)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_summary_kernel_wrapper_refuses_what_it_cannot_take():
    before = dt.launches
    doc = torch.zeros(1, 10, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        dt.doc_tiles_cuda(doc, 640, 64, None, True)
    with pytest.raises(ValueError, match="frames"):
        dt.doc_tiles(doc, 700, 64, None, True)
    assert dt.launches == before


def summary_by_loops(doc, L, tpf, window, causal):
    """The summary kernel's algorithm (csrc/frame_attention.cu
    doc_tiles_kernel) as plain loops: binary searches on rows whose ids
    never decrease, a tile's ids over its rows below L, the work of each
    128-row tile from its clipped frames, and ranks by decreasing work."""
    import bisect
    B, nf = doc.shape
    n64, n128 = -(-L // 64), -(-L // 128)
    w = window or 0
    out = []
    for d in doc.tolist():
        row = [0] * dt.doc_tiles_row(L, tpf)
        mono = all(d[f] <= d[f + 1] for f in range(nf - 1))
        for f in range(nf):
            row[4 * n64 + 2 * f:4 * n64 + 2 * f + 2] = (
                [bisect.bisect_left(d, d[f]), bisect.bisect_right(d, d[f]) - 1]
                if mono else [0, nf - 1])
        for t in range(n64):
            fa, fz = 64 * t // tpf, (min(64 * t + 64, L) - 1) // tpf
            lo, hi = min(d[fa:fz + 1]), max(d[fa:fz + 1])
            row[4 * t:4 * t + 4] = [lo, hi] + (
                [bisect.bisect_left(d, lo), bisect.bisect_right(d, hi) - 1]
                if mono else [0, nf - 1])
        work = ([], [])
        for t in range(n128):
            span = range(2 * t, min(2 * t + 2, n64))
            first = min(row[4 * i + 2] for i in span)
            last = max(row[4 * i + 3] for i in span)
            f_lo, f_hi = 128 * t // tpf, (min(128 * t + 128, L) - 1) // tpf
            k_lo = max(max(0, f_lo - w + 1) if w > 0 else 0, first)
            k_hi = min(f_hi if causal else (min(nf - 1, f_hi + w - 1)
                                            if w > 0 else nf - 1), last)
            q_lo = max(f_lo if causal else (max(0, f_lo - w + 1)
                                            if w > 0 else 0), first)
            q_hi = min(min(nf - 1, f_hi + w - 1) if w > 0 else nf - 1, last)
            work[0].append(min((k_hi + 1) * tpf, L) - k_lo * tpf)
            work[1].append(min((q_hi + 1) * tpf, L) - q_lo * tpf)
        o = 4 * n64 + 2 * nf
        for side, wk in enumerate(work):
            for t in range(n128):
                rank = sum(wk[u] > wk[t] or (wk[u] == wk[t] and u < t)
                           for u in range(n128))
                row[o + side * n128 + rank] = t
        row[o + 2 * n128] = int(mono)
        out.append(row)
    return torch.tensor(out, dtype=torch.int32)


@pytest.mark.parametrize("L,tpf,window,causal", [
    (1040, 65, None, True), (3900, 65, 16, False), (4096, 64, None, True),
    (1300, 13, 3, False), (200, 7, 5, True)])
def test_plain_summary_is_the_kernels_algorithm(L, tpf, window, causal):
    """doc_tiles against the kernel's loops, int for int, on ragged L (the
    last 64-row tile past L), for the three layouts."""
    nf = -(-L // tpf)
    rng = np.random.RandomState(L)
    for kind in ("nondecreasing", "decreasing", "repeated"):
        doc = torch.from_numpy(np.stack([layout(kind, nf, rng),
                                         layout("nondecreasing", nf, rng)])
                               .astype(np.int32))
        assert torch.equal(dt.doc_tiles(doc, L, tpf, window, causal),
                           summary_by_loops(doc, L, tpf, window, causal)), \
            kind
