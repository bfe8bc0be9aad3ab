"""Append-only columnar store (the port's own copy of
owl_audio_exps_tpu/data/npy_table.py): schema.json + manifest.json + one
.npy per array cell, read through mmap.

The on-disk format is the JAX package's (and the reference store's,
owl_wms/data/npy_table.py), so a table written by either package reads
back identically in the other.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Iterable, List, Optional, Sequence

import numpy as np

DEFAULT_COLUMNS = [
    "video", "audio", "mouse", "buttons",
    "tarball", "pt_idx", "missing", "truncated", "seq_len",
]
DEFAULT_ARRAY_COLUMNS = {"video", "audio", "mouse", "buttons"}


class NpyTable:
    def __init__(self, directory: str, columns: Optional[List[str]] = None,
                 array_columns: Optional[Iterable[str]] = None):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)

        self.schema_path = self.directory / "schema.json"
        if self.schema_path.exists():
            schema = json.loads(self.schema_path.read_text())
            if columns is not None and columns != schema["columns"]:
                raise ValueError("columns mismatch with existing schema")
            if array_columns is not None and \
                    set(array_columns) != set(schema["array_columns"]):
                raise ValueError("array_columns mismatch with existing schema")
            columns = schema["columns"]
            array_columns = schema["array_columns"]
        else:
            columns = columns or list(DEFAULT_COLUMNS)
            array_columns = list(array_columns or DEFAULT_ARRAY_COLUMNS)
            self.schema_path.write_text(json.dumps(
                {"columns": columns, "array_columns": array_columns}))

        self.columns = list(columns)
        self.array_columns = set(array_columns)

        self.manifest_path = self.directory / "manifest.json"
        self.manifest = (json.loads(self.manifest_path.read_text())
                         if self.manifest_path.exists() else [])

    def __len__(self) -> int:
        return len(self.manifest)

    def append(self, **row: Any) -> int:
        if set(row) != set(self.columns):
            raise ValueError(f"Expected columns {self.columns}, got {list(row)}")
        idx = len(self.manifest)
        entry = {}
        for key, val in row.items():
            if key in self.array_columns:
                fname = f"{key}_{idx}.npy"
                np.save(self.directory / fname, np.ascontiguousarray(val),
                        allow_pickle=False)
                entry[key] = fname
            else:
                entry[key] = val
        self.manifest.append(entry)
        self.manifest_path.write_text(json.dumps(self.manifest))
        return idx

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.get([key])[0]
        if isinstance(key, (list, tuple)):
            return self.get(list(key))
        raise KeyError(f"Invalid key: {key!r}")

    def get(self, columns: List[str],
            rows: Optional[Sequence[int]] = None) -> List[List[Any]]:
        """Column-major reads; array cells come back as mmap views."""
        invalid = set(columns) - set(self.columns)
        if invalid:
            raise KeyError(f"Unknown columns requested: {invalid}")
        rows = range(len(self.manifest)) if rows is None else rows
        out = []
        for col in columns:
            cells = []
            for r in rows:
                cell = self.manifest[r][col]
                if col in self.array_columns:
                    cell = np.load(self.directory / cell, mmap_mode="r")
                cells.append(cell)
            out.append(cells)
        return out
