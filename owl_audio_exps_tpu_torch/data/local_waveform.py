"""Local stereo-waveform loader (counterpart of
owl_audio_exps_tpu/data/local_waveform.py): random windows of
``window_length`` samples (88,200 = 2 s at 44.1 kHz in the configs) from
the ``*_wf.pt`` files under ``root_dir``.

Files are torch tensors [N, 2], loaded mmap'd; batches are numpy float32
[b, window, 2], an infinite iterator. A file shorter than the window is
zero-padded. The file and window draws come from
``np.random.RandomState(1234 + process_index)`` in the JAX loader's
order, so both packages read the same windows.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch


def _load_waveform(path: str) -> np.ndarray:
    return torch.load(path, mmap=True, map_location="cpu",
                      weights_only=True).numpy()


class LocalWaveformDataset:
    def __init__(self, root_dir: str, window_length: int, seed: int = 0):
        self.root_dir = root_dir
        self.window_length = window_length
        self.paths: List[str] = []
        for root, _, files in os.walk(root_dir):
            for f in files:
                if f.endswith("_wf.pt"):
                    self.paths.append(os.path.join(root, f))
        if not self.paths:
            raise ValueError(f"No *_wf.pt files found in {root_dir}")
        self._rs = np.random.RandomState(seed)

    def sample(self) -> np.ndarray:
        path = self.paths[self._rs.randint(len(self.paths))]
        wf = _load_waveform(path)
        n = wf.shape[0]
        W = self.window_length
        if n <= W:
            out = np.zeros((W, 2), dtype=np.float32)
            out[:n] = wf
            return out
        start = self._rs.randint(0, n - W)
        return np.asarray(wf[start:start + W], dtype=np.float32)


class WaveformLoader:
    """Infinite [b, window, 2] float32 batches."""

    def __init__(self, dataset: LocalWaveformDataset, batch_size: int):
        self.ds = dataset
        self.batch_size = batch_size

    def __iter__(self):
        while True:
            yield np.stack([self.ds.sample() for _ in range(self.batch_size)])


def get_loader(batch_size, root_dir, window_length, process_index: int = 0,
               **_):
    ds = LocalWaveformDataset(root_dir, window_length,
                              seed=1234 + process_index)
    return WaveformLoader(ds, batch_size)
