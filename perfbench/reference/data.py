"""The training batches worked out again from what the benchmark made,
by the published loaders' rules (owl-audio-exps ``sequence_packing`` and
the synthetic source), so that the reference never reads a batch the
program assembled.

* Packing: an epoch's documents in ``RandomState(epoch).permutation``
  order, laid end to end and cut into whole windows; the windows are
  visited in ``RandomState(epoch).permutation`` order (the loader's
  shuffle seed is 0); each frame carries its document's index in that
  epoch's order as its ``doc_id``.
* Synthetic: one ``RandomState`` stream, each batch its columns drawn in
  order (normal float32, or Bernoulli 0.5 as float32).
"""

from __future__ import annotations

from typing import List

import numpy as np


def packed_batches(docs: List[dict], window: int, n: int,
                   columns=("video", "mouse", "buttons")):
    """The first ``n`` batches of the packing loader over ``docs`` (each
    a dict of per-frame arrays, in table order): [[col arrays with a
    batch axis of 1 ..., doc_id [1, window] int32], ...]."""
    out, epoch = [], 0
    while len(out) < n:
        perm = np.random.RandomState(epoch).permutation(len(docs))
        lens = np.array([len(docs[i][columns[0]]) for i in perm])
        starts = np.concatenate(([0], np.cumsum(lens)[:-1]))
        ends = starts + lens
        n_win = int(ends[-1]) // window
        order = np.random.RandomState(epoch).permutation(n_win)
        for w in order:
            lo, hi = w * window, (w + 1) * window
            cols = {c: [] for c in columns}
            ids = []
            for d in range(len(perm)):
                a, b = max(lo, starts[d]), min(hi, ends[d])
                if a >= b:
                    continue
                doc = docs[perm[d]]
                for c in columns:
                    cols[c].append(doc[c][a - starts[d]:b - starts[d]])
                ids += [d] * int(b - a)
            out.append([np.concatenate(cols[c])[None].astype(np.float32)
                        for c in columns]
                       + [np.asarray(ids, np.int32)[None]])
            if len(out) == n:
                break
        epoch += 1
    return out


def synthetic_batches(seed: int, shapes, n: int):
    """The first ``n`` batches of a synthetic stream seeded ``seed``;
    ``shapes`` is [(shape with the batch axis, "normal" | "binary")]."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        row = []
        for shape, kind in shapes:
            if kind == "binary":
                row.append((rs.rand(*shape) > 0.5).astype(np.float32))
            else:
                row.append(rs.randn(*shape).astype(np.float32))
        out.append(row)
    return out
