"""Control-sequence augmentation (counterpart of
owl_audio_exps_tpu/utils/controls.py): double the control sequences by
concatenating a batch-permuted clone until they reach the target length,
then truncate."""

from __future__ import annotations

from typing import Optional

import torch


def batch_permute(mouse, button, factor: int = 1,
                  generator: Optional[torch.Generator] = None):
    for _ in range(factor):
        inds = torch.randperm(mouse.shape[0], generator=generator,
                              device=generator.device if generator
                              else mouse.device).to(mouse.device)
        mouse = torch.cat([mouse, mouse[inds]], dim=1)
        button = torch.cat([button, button[inds]], dim=1)
    return mouse, button


def batch_permute_to_length(mouse, button, length: int,
                            generator: Optional[torch.Generator] = None):
    n = mouse.shape[1]
    factor = 0
    doubled = n
    while doubled < length:
        factor += 1
        doubled *= 2
    mouse, button = batch_permute(mouse, button, factor, generator)
    return mouse[:, :length], button[:, :length]
