"""Shared sampler utilities (counterpart of
owl_audio_exps_tpu/sampling/common.py)."""

from __future__ import annotations

from typing import Optional

import torch


def randn(shape, dtype, device, generator: Optional[torch.Generator]):
    """float32 normal noise cast to ``dtype``."""
    return torch.randn(shape, dtype=torch.float32, device=device,
                       generator=generator).to(dtype)


def zlerp(x: torch.Tensor, alpha: float,
          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Partial re-noising: x * (1 - alpha) + z * alpha."""
    z = randn(x.shape, x.dtype, x.device, generator)
    return x * (1.0 - alpha) + z * alpha
