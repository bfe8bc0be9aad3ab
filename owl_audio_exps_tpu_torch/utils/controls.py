"""Control-sequence augmentation (counterpart of
owl_audio_exps_tpu/utils/controls.py): double the control sequences by
concatenating a batch-permuted clone until they reach the target length,
then truncate. The permutations come from ``generator``, or from
``perms`` (one row of batch indices per doubling) when a caller hands
them in."""

from __future__ import annotations

from typing import Optional

import torch


def doublings_to_length(n: int, length: int) -> int:
    """How many doublings take n frames to at least ``length``."""
    factor = 0
    while n << factor < length:
        factor += 1
    return factor


def batch_permute(mouse, button, factor: int = 1,
                  generator: Optional[torch.Generator] = None,
                  perms: Optional[torch.Tensor] = None):
    for i in range(factor):
        if perms is not None:
            inds = perms[i].to(mouse.device)
        else:
            inds = torch.randperm(mouse.shape[0], generator=generator,
                                  device=generator.device if generator
                                  else mouse.device).to(mouse.device)
        mouse = torch.cat([mouse, mouse[inds]], dim=1)
        button = torch.cat([button, button[inds]], dim=1)
    return mouse, button


def batch_permute_to_length(mouse, button, length: int,
                            generator: Optional[torch.Generator] = None,
                            perms: Optional[torch.Tensor] = None):
    factor = doublings_to_length(mouse.shape[1], length)
    mouse, button = batch_permute(mouse, button, factor, generator, perms)
    return mouse[:, :length], button[:, :length]
