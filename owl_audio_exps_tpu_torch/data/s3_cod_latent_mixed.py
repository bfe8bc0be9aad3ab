"""Mixed labelled / unlabelled S3 loader of the joint AV model (the
port's own copy of owl_audio_exps_tpu/data/s3_cod_latent_mixed.py;
reference owl_wms/data/s3_cod_latent_mixed.py): two prefixes feed two
queues. The labelled prefix's tars carry ``.mouse.pt`` / ``.buttons.pt``
members, the unlabelled prefix's do not (its controls are zeros,
reference :190-193); both carry ``.audiolatent.pt``. Per item a
bernoulli(unlabelled_frac) picks the source queue (reference :222-243).
Batches follow the reference collate order [vid, audio, mouse, buttons,
has_controls] (reference :247-256).
"""

from __future__ import annotations

import random
import time

import numpy as np

from .s3_cod_latent import S3CoDLoader


class S3CoDMixedLoader:
    def __init__(self, batch_size: int, bucket_name: str,
                 labelled_prefix: str, unlabelled_prefix: str,
                 window_length: int = 16, file_share_max: int = 50,
                 unlabelled_frac: float = 0.5, process_index: int = 0,
                 n_buttons: int = 11, n_mouse_axes: int = 2, **kw):
        self.batch_size = batch_size
        self.unlabelled_frac = unlabelled_frac
        self._rng = random.Random(777 + process_index)
        self.labelled = S3CoDLoader(
            1, bucket_name, labelled_prefix, window_length, file_share_max,
            process_index=process_index, include_audio=True,
            n_buttons=n_buttons, n_mouse_axes=n_mouse_axes, **kw)
        self.unlabelled = S3CoDLoader(
            1, bucket_name, unlabelled_prefix, window_length, file_share_max,
            process_index=process_index + 10000, include_audio=True,
            zero_controls=True, n_buttons=n_buttons,
            n_mouse_axes=n_mouse_axes, **kw)

    def sleep_until_queues_filled(self):
        while (self.labelled.queue.qsize() < self.batch_size or
               self.unlabelled.queue.qsize() < self.batch_size):
            time.sleep(0.5)

    def __iter__(self):
        while True:
            vids, auds, mouses, btns, flags = [], [], [], [], []
            for _ in range(self.batch_size):
                if self._rng.random() < self.unlabelled_frac:
                    v, m, b, a = self.unlabelled.queue.get()
                    flags.append(False)
                else:
                    v, m, b, a = self.labelled.queue.get()
                    flags.append(True)
                vids.append(v)
                auds.append(a)
                mouses.append(m)
                btns.append(b)
            yield [np.stack(vids).astype(np.float32),
                   np.stack(auds).astype(np.float32),
                   np.stack(mouses).astype(np.float32),
                   np.stack(btns).astype(np.float32),
                   np.asarray(flags, dtype=bool)]


def get_loader(batch_size, bucket_name, labelled_prefix="labelled",
               unlabelled_prefix="unlabelled", window_length=16,
               unlabelled_frac=0.5, process_index: int = 0, **kw):
    return S3CoDMixedLoader(batch_size, bucket_name, labelled_prefix,
                            unlabelled_prefix, window_length,
                            unlabelled_frac=unlabelled_frac,
                            process_index=process_index, **kw)
