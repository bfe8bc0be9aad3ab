"""Streaming S3 tar loader (the port's own copy of
owl_audio_exps_tpu/data/s3_cod_latent.py; reference
owl_wms/data/s3_cod_latent.py:16-228): a download thread, an unpack
thread and a randomized queue.

Tars hold ``.latent.pt`` / ``.mouse.pt`` / ``.buttons.pt`` members (and
``.audiolatent.pt`` with ``include_audio``), read with
``torch.load(weights_only=True)``; up to ``file_share_max`` random
windows are drawn per file and buffered in a bounded randomized queue.
Each process draws from its own random stream, seeded by its
``process_index`` (the batch rank) as in the JAX package, so both
packages cut the same windows from the same tar.

Requires boto3; building a loader without it raises ImportError.
"""

from __future__ import annotations

import io
import random
import tarfile
import threading
import time
from typing import List, Optional

import numpy as np
import torch


class RandomizedQueue:
    """Bounded buffer; get() pops a uniformly random element."""

    def __init__(self, max_size: int = 1000, seed: int = 0):
        self.max_size = max_size
        self._items: List = []
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._rng = random.Random(seed)

    def put(self, item, timeout: Optional[float] = None):
        with self._not_full:
            while len(self._items) >= self.max_size:
                if not self._not_full.wait(timeout):
                    return False
            self._items.append(item)
            self._not_empty.notify()
            return True

    def get(self):
        with self._not_empty:
            while not self._items:
                self._not_empty.wait()
            idx = self._rng.randrange(len(self._items))
            self._items[idx], self._items[-1] = \
                self._items[-1], self._items[idx]
            item = self._items.pop()
            self._not_full.notify()
            return item

    def qsize(self) -> int:
        with self._lock:
            return len(self._items)


def _load_pt(buf: bytes) -> np.ndarray:
    return torch.load(io.BytesIO(buf), map_location="cpu",
                      weights_only=True).float().numpy()


class S3CoDLoader:
    """Infinite iterator of [vid, mouse, buttons] numpy batches."""

    def __init__(self, batch_size: int, bucket_name: str, prefix: str = "",
                 window_length: int = 16, file_share_max: int = 50,
                 queue_size: int = 1000, max_inflight_tars: int = 2,
                 process_index: int = 0, include_audio: bool = False,
                 zero_controls: bool = False, n_buttons: int = 11,
                 n_mouse_axes: int = 2, **_):
        # include_audio: also unpack ``.audiolatent.pt`` members and yield
        # [vid, audio, mouse, btn] (the mixed-AV tar schema, reference
        # s3_cod_latent_mixed.py:177-215). zero_controls: the tar has no
        # control members (unconditional prefix) — synthesize zeros
        # (reference s3_cod_latent_mixed.py:190-193).
        try:
            import boto3  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "S3 loaders require boto3, which is not installed; "
                "use data_id 'cod' or a synthetic_* source instead") from e
        import boto3
        self.s3 = boto3.client("s3")
        self.bucket = bucket_name
        self.prefix = prefix
        self.batch_size = batch_size
        self.window_length = window_length
        self.file_share_max = file_share_max
        self.include_audio = include_audio
        self.zero_controls = zero_controls
        self.n_buttons = n_buttons
        self.n_mouse_axes = n_mouse_axes
        self.n_cols = 4 if include_audio else 3
        self.queue = RandomizedQueue(queue_size, seed=process_index)
        self._tar_queue: "List[bytes]" = []
        self._tar_lock = threading.Semaphore(max_inflight_tars)
        self._rng = random.Random(4242 + process_index)

        self._keys = self._list_keys()
        for target in (self._download_loop, self._unpack_loop):
            threading.Thread(target=target, daemon=True).start()

    def _list_keys(self) -> List[str]:
        keys = []
        paginator = self.s3.get_paginator("list_objects_v2")
        for page in paginator.paginate(Bucket=self.bucket, Prefix=self.prefix):
            for obj in page.get("Contents", []):
                if obj["Key"].endswith(".tar"):
                    keys.append(obj["Key"])
        self._rng.shuffle(keys)
        return keys

    def _download_loop(self):
        while True:
            for key in self._keys:
                self._tar_lock.acquire()
                try:
                    buf = io.BytesIO()
                    self.s3.download_fileobj(self.bucket, key, buf)
                    self._tar_queue.append(buf.getvalue())
                except Exception:
                    self._tar_lock.release()
                    time.sleep(1.0)  # swallow + retry forever (reference)
            self._rng.shuffle(self._keys)

    def _unpack_loop(self):
        while True:
            if not self._tar_queue:
                time.sleep(0.1)
                continue
            data = self._tar_queue.pop(0)
            self._tar_lock.release()
            try:
                self._unpack_tar(data)
            except Exception:
                time.sleep(0.1)

    def _unpack_tar(self, data: bytes):
        suffixes = [".latent.pt"]
        if not self.zero_controls:
            suffixes += [".mouse.pt", ".buttons.pt"]
        if self.include_audio:
            suffixes.append(".audiolatent.pt")
        groups = {}
        with tarfile.open(fileobj=io.BytesIO(data)) as tf:
            for member in tf.getmembers():
                name = member.name
                for suffix in suffixes:
                    if name.endswith(suffix):
                        stem = name[: -len(suffix)]
                        groups.setdefault(stem, {})[suffix] = \
                            _load_pt(tf.extractfile(member).read())
        for stem, parts in groups.items():
            if len(parts) != len(suffixes):
                continue
            vid = parts[".latent.pt"]
            if self.zero_controls:
                mouse = np.zeros((vid.shape[0], self.n_mouse_axes),
                                 np.float32)
                btn = np.zeros((vid.shape[0], self.n_buttons), np.float32)
            else:
                mouse = parts[".mouse.pt"]
                btn = parts[".buttons.pt"]
            audio = parts.get(".audiolatent.pt")
            n = vid.shape[0]
            if audio is not None:
                n = min(n, audio.shape[0], mouse.shape[0], btn.shape[0])
            if n < self.window_length:
                continue
            for _ in range(min(self.file_share_max,
                               max(1, n // self.window_length))):
                s = self._rng.randint(0, n - self.window_length)
                e = s + self.window_length
                item = (np.clip(np.nan_to_num(vid[s:e]), -8, 8),
                        mouse[s:e], btn[s:e])
                if audio is not None:
                    item = item + (audio[s:e],)
                self.queue.put(item)

    def __iter__(self):
        # queue tuples are (vid, mouse, btn[, audio]); the documented
        # yield contract is [vid, audio, mouse, btn] (the mixed-AV tar
        # schema / AV-trainer batch order, rft_trainer.AVRFTTrainer) —
        # reorder so audio lands in column 1, not appended last
        order = (0, 3, 1, 2) if self.include_audio else (0, 1, 2)
        while True:
            items = [self.queue.get() for _ in range(self.batch_size)]
            yield [np.stack([it[j] for it in items]).astype(np.float32)
                   for j in order]

    def sleep_until_queues_filled(self, min_items: Optional[int] = None):
        """Startup barrier (reference: s3_cod_latent_mixed.py:121-145)."""
        target = min_items if min_items is not None else self.batch_size
        while self.queue.qsize() < target:
            time.sleep(0.5)


def get_loader(batch_size, bucket_name, prefix="", window_length=16,
               file_share_max=50, process_index: int = 0, **kw):
    return S3CoDLoader(batch_size, bucket_name, prefix, window_length,
                       file_share_max, process_index=process_index, **kw)
