"""Miscellaneous helpers (counterpart of owl_audio_exps_tpu/utils/__init__.py):
``freeze`` and ``find_unused_params`` over named tensors or a module's
parameters."""

from __future__ import annotations

from typing import Dict, List, Mapping, Union

import torch

Named = Union[Mapping[str, torch.Tensor], torch.nn.Module]


def freeze(params: Named) -> Dict[str, torch.Tensor]:
    """{name: a detached view (requires_grad False)} of the tensors, or of
    a module's parameters: gradients stop there, as the JAX package's
    ``stop_gradient`` over a tree."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return {name: t.detach() for name, t in params.items()}


def find_unused_params(grads: Named, atol: float = 0.0) -> List[str]:
    """Names whose gradients are zero within ``atol``: {name: gradient},
    or a module after a backward (a parameter without a gradient counts
    as unused)."""
    if isinstance(grads, torch.nn.Module):
        grads = {n: p.grad for n, p in grads.named_parameters()}
    return [name for name, g in grads.items()
            if g is None or bool((g.detach().abs() <= atol).all())]
