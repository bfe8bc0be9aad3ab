"""Pre-encode loader samples into warm-start buffers for the window
pipeline (counterpart of the root inference/build_cache.py).

One ``buffers_{i}.npz`` per sample, with ``history`` (video latents [b,
n, c, h, w]), ``audio`` ([b, n, audio_channels]; zeros for a loader
without an audio column), ``mouse`` and ``button``, as the loader of
``train.data_id`` yields them. ``CausvidPipeline.load_cache``
(inference/pipeline.py) reads them back.

    python -m owl_audio_exps_tpu_torch.inference.build_cache \\
        --config_path configs/av_v4_8x8.yml --out_dir data_cache

The loader runs on the host; nothing here touches a device.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_cache(cfg, out_dir: str, n_samples: int):
    """Write ``n_samples`` buffers of the config's loader (batch 1) into
    ``out_dir``; returns their paths."""
    from ..data import get_loader
    loader = iter(get_loader(cfg.train.data_id, 1,
                             **dict((cfg.train.data_kwargs or {}).items())))
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i in range(n_samples):
        batch = next(loader)
        if len(batch) >= 4:
            vid, audio, mouse, btn = batch[:4]
        else:
            vid, mouse, btn = batch[:3]
            audio = np.zeros((vid.shape[0], vid.shape[1],
                              cfg.model.audio_channels), np.float32)
        path = os.path.join(out_dir, f"buffers_{i}.npz")
        np.savez(path, history=vid, audio=audio, mouse=mouse, button=btn)
        paths.append(path)
    return paths


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--out_dir", default="data_cache")
    parser.add_argument("--n_samples", type=int, default=100)
    args = parser.parse_args(argv)

    from ..configs import Config
    cfg = Config.from_yaml(args.config_path)
    build_cache(cfg, args.out_dir, args.n_samples)
    print(f"wrote {args.n_samples} warm-start buffers to {args.out_dir}")


if __name__ == "__main__":
    main()
