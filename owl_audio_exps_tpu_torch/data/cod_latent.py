"""Windowed latent dataset over an NpyTable, a host-side numpy iterator
(the port's own copy of owl_audio_exps_tpu/data/cod_latent.py; reference
owl_wms/data/cod_latent.py, WindowedViewDataset + DataLoader).

Each process takes a strided slice of the shuffled index, reshuffled
every epoch from ``np.random.RandomState(seed + epoch)`` as the JAX
package does, so both packages yield the same batches in the same order.
The trainers pass the batch rank and the number of batch ranks (data x
fsdp; the tensor and seq ranks of one batch rank share its shard). Whole batches are read through
the native gather (data/native_loader.py). Float arrays are served
float32; the trainer casts on the device.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .npy_table import NpyTable

META_COLS = ("tarball", "pt_idx", "missing", "truncated", "seq_len")


class WindowedViewDataset:
    """Sliding non-overlapping windows over table rows."""

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

        seq_len, missing, truncated = self.table[
            ["seq_len", "missing", "truncated"]]
        self._index = []
        for i, (L, miss, trunc) in enumerate(zip(seq_len, missing, truncated)):
            if not include_missing_features and miss:
                continue
            if not include_truncated and trunc:
                continue
            for start in range(0, int(L), window_length):
                if start + window_length <= int(L):
                    self._index.append((i, start))

    def __len__(self):
        return len(self._index)

    def __getitem__(self, idx):
        row, start = self._index[idx]
        arrays = self.table.get(self.array_columns, rows=[row])
        return {
            col: np.asarray(arr[0][start:start + self.window_length])
            for col, arr in zip(self.array_columns, arrays)
        }

    # ---- native batch fast path -------------------------------------
    def _file_meta(self, row: int, col: str):
        """(path, header_offset, dtype, trailing_shape, row_bytes) for a
        table cell, memoized."""
        if not hasattr(self, "_meta_cache"):
            self._meta_cache = {}
        key = (row, col)
        if key not in self._meta_cache:
            from .native_loader import npy_data_offset
            path = str(self.table.directory / self.table.manifest[row][col])
            off, dtype, shape = npy_data_offset(path)
            trailing = shape[1:]
            row_bytes = int(np.prod(trailing, dtype=np.int64)
                            * dtype.itemsize) if trailing else dtype.itemsize
            self._meta_cache[key] = (path, off, dtype, trailing, row_bytes)
        return self._meta_cache[key]

    def batch(self, indices, columns=None, impl: str = "native"):
        """Assemble a whole batch per column through the native gather
        (csrc/owl_loader.cpp): parallel positioned reads, no Python in
        the per-item loop. ``impl="plain"`` reads with numpy instead."""
        from .native_loader import gather_windows
        columns = columns or self.array_columns
        out = {}
        for col in columns:
            paths, starts, offsets = [], [], []
            dtype = trailing = row_bytes = None
            for idx in indices:
                row, start = self._index[int(idx)]
                path, off, dt, tr, rb = self._file_meta(row, col)
                paths.append(path)
                starts.append(start)
                offsets.append(off)
                dtype, trailing, row_bytes = dt, tr, rb
            out[col] = gather_windows(paths, starts, self.window_length,
                                      row_bytes, offsets, dtype, trailing,
                                      impl=impl)
        return out


class EpochShuffleLoader:
    """Infinite batch iterator: per-epoch reshuffle (epoch-seeded, matching
    AutoEpochDistributedSampler semantics), process-strided sharding,
    drop_last."""

    def __init__(self, dataset, batch_size: int, batch_columns: List[str],
                 process_index: int = 0, process_count: int = 1,
                 seed: int = 0, extra_columns: Optional[List[str]] = None):
        self.ds = dataset
        self.batch_size = batch_size
        self.batch_columns = list(batch_columns)
        self.extra_columns = list(extra_columns or [])
        self.process_index = process_index
        self.process_count = process_count
        self.seed = seed
        self.epoch = 0

    def _epoch_indices(self):
        rs = np.random.RandomState(self.seed + self.epoch)
        perm = rs.permutation(len(self.ds))
        return perm[self.process_index::self.process_count]

    def __iter__(self):
        use_native = (not self.extra_columns) and hasattr(self.ds, "batch")
        while True:
            if hasattr(self.ds, "set_epoch"):
                self.ds.set_epoch(self.epoch)
            idxs = self._epoch_indices()
            n_batches = len(idxs) // self.batch_size
            for bi in range(n_batches):
                batch_idx = idxs[bi * self.batch_size:
                                 (bi + 1) * self.batch_size]
                if use_native:
                    cols = self.ds.batch(batch_idx, self.batch_columns)
                    yield [_float_cast(cols[c]) for c in self.batch_columns]
                else:
                    rows = [self.ds[int(i)] for i in batch_idx]
                    cols = self.batch_columns + self.extra_columns
                    yield [_stack_cast([r[c] for r in rows]) for c in cols]
            self.epoch += 1


def _float_cast(arr: np.ndarray) -> np.ndarray:
    if np.issubdtype(arr.dtype, np.floating):
        return arr.astype(np.float32, copy=False)
    return arr


def _stack_cast(cells) -> np.ndarray:
    """Stack a batch column; float arrays normalize to float32 (device
    casts to bf16 — the analogue of the reference collate's bf16 cast,
    owl_wms/data/cod_latent.py:72-79)."""
    out = np.stack(cells)
    if np.issubdtype(out.dtype, np.floating):
        return out.astype(np.float32)
    return out


def get_loader(batch_size, dataset_path, window_length, batch_columns,
               process_index: int = 0, process_count: int = 1, **_):
    ds = WindowedViewDataset(dataset_path, window_length)
    return EpochShuffleLoader(ds, batch_size, batch_columns,
                              process_index, process_count)
