"""Sequence packing (the port's own copy of
owl_audio_exps_tpu/data/latent_seq_packing.py; reference
owl_wms/data/latent_seq_packing.py:27-164): whole permuted documents
packed into fixed windows, with a per-frame ``doc_id`` (int32) that the
model's attention takes as its document mask (K1 with documents).

Packing is deterministic per epoch: the permutation is
``np.random.RandomState(epoch)``, the same on every process and in both
packages. ``batch_size`` must be 1.

Documents are laid end to end in permuted order; the concatenated stream
is cut into exact ``window_length`` chunks; each chunk lists its (doc,
lo, hi) spans, found with searchsorted over the cumulative document
offsets. A trailing partial window is dropped.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .npy_table import NpyTable
from .cod_latent import META_COLS, EpochShuffleLoader


class PackedSequenceDataset:
    def __init__(self, table_dir: str, window_length: int,
                 include_missing_features: bool = False,
                 include_truncated: bool = True,
                 array_columns: Optional[List[str]] = None):
        self.window_length = window_length
        self.table = NpyTable(table_dir)
        if array_columns is None:
            self.array_columns = [c for c in self.table.columns
                                  if c not in META_COLS]
        else:
            self.array_columns = list(array_columns)

        seq_len, missing, truncated = [
            np.asarray(x) for x in
            self.table[["seq_len", "missing", "truncated"]]]
        mask = np.ones_like(seq_len, dtype=bool)
        if not include_missing_features:
            mask &= ~missing.astype(bool)
        if not include_truncated:
            mask &= ~truncated.astype(bool)

        self._docs = np.nonzero(mask)[0]
        self._lens = seq_len[mask].astype(np.int64)
        if not (self._lens > 0).all():
            raise ValueError(f"{table_dir}: a document of length 0")
        self._build(np.arange(len(self._docs)))

    def set_epoch(self, epoch: int):
        rs = np.random.RandomState(epoch)  # deterministic across hosts
        self._build(rs.permutation(len(self._docs)))

    def _build(self, perm):
        self._row_lookup = self._docs[perm]
        lens = self._lens[perm]
        W = self.window_length
        starts = np.concatenate(([0], np.cumsum(lens)[:-1]))
        ends = starts + lens
        total = int(ends[-1]) if len(ends) else 0
        n_windows = total // W  # full windows only

        self._slices = []
        for w in range(n_windows):
            wlo, whi = w * W, (w + 1) * W
            # docs overlapping [wlo, whi): start < whi and end > wlo
            first = int(np.searchsorted(ends, wlo, side="right"))
            last = int(np.searchsorted(starts, whi, side="left"))
            spans = []
            for d in range(first, last):
                lo = max(wlo, int(starts[d])) - int(starts[d])
                hi = min(whi, int(ends[d])) - int(starts[d])
                spans.append((d, lo, hi))
            self._slices.append(spans)

    def __len__(self):
        return len(self._slices)

    def __getitem__(self, idx):
        spans = self._slices[idx]
        sample = {c: [] for c in self.array_columns}
        doc_id = []
        for doc, lo, hi in spans:
            row = int(self._row_lookup[doc])
            arrays = self.table.get(self.array_columns, rows=[row])
            for col, arr in zip(self.array_columns, arrays):
                sample[col].append(np.asarray(arr[0][lo:hi]))
            doc_id.extend([doc] * (hi - lo))
        out = {k: np.concatenate(v) for k, v in sample.items()}
        out["doc_id"] = np.asarray(doc_id, dtype=np.int32)
        return out


def get_loader(batch_size, dataset_path, window_length, batch_columns,
               process_index: int = 0, process_count: int = 1, **_):
    if batch_size != 1:
        raise ValueError("sequence packing requires batch_size 1")
    ds = PackedSequenceDataset(dataset_path, window_length,
                               array_columns=batch_columns)
    return EpochShuffleLoader(ds, batch_size, batch_columns,
                              process_index, process_count,
                              extra_columns=["doc_id"])
