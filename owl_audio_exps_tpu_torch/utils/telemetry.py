"""Parameter and gradient telemetry of the train step (counterpart of
owl_audio_exps_tpu/utils/telemetry.py), the ``train.watch`` knob:

* ``norms``: the L2 norm of the parameters and of the gradients of each
  module, grouped by the first ``depth`` (2) components of the parameter
  name (``core.transformer.blocks.0.attn...`` -> ``core/transformer``, the
  JAX package's tree prefix);
* ``full``: also a histogram of every parameter value and of every
  gradient value, ``bins`` equal bins between the step's minimum and
  maximum (counts, lo, hi).

Everything is computed on the device inside the step and returned as
device tensors; only ``torch.bincount`` (``full``) reads its input's range
back to the host, once per chunk of elements. Over parameters
split by the fsdp, tensor or pipe axes, trainers/base.py
``BaseTrainer.watch`` computes the same dict from this rank's slices
with these helpers and a few collectives.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch

Named = Iterable[Tuple[str, torch.Tensor]]


def group_key(name: str, depth: int = 2) -> str:
    """The group of a parameter: the first ``depth`` components of its
    name, joined by "/"."""
    return "/".join(name.split(".")[:depth]) or "root"


def _groups(named: Named, depth: int) -> Dict[str, List[torch.Tensor]]:
    groups: Dict[str, List[torch.Tensor]] = {}
    for name, t in named:
        groups.setdefault(group_key(name, depth), []).append(t)
    return groups


def group_norms(named: Named, prefix: str,
                depth: int = 2) -> Dict[str, torch.Tensor]:
    """{'<prefix>/<module>': L2 norm} over the depth-limited groups."""
    return {f"{prefix}/{key}": torch.sqrt(sum(t.float().pow(2).sum()
                                              for t in ts))
            for key, ts in _groups(named, depth).items()}


def value_histogram(tensors: List[torch.Tensor], bins: int = 64):
    """(counts [bins] int32, lo, hi) over every element of ``tensors``,
    the range this step's min and max."""
    lo, hi = value_range(tensors)
    return bin_counts(tensors, lo, hi, bins).to(torch.int32), lo, hi


def value_range(tensors: List[torch.Tensor]):
    """(min, max) over every element of ``tensors``, float32."""
    lo = torch.stack([t.detach().float().amin() for t in tensors]).amin()
    hi = torch.stack([t.detach().float().amax() for t in tensors]).amax()
    return lo, hi


def bin_counts(tensors: List[torch.Tensor], lo, hi, bins: int,
               chunk: int = 1 << 26) -> torch.Tensor:
    """int64 counts of the elements of ``tensors`` in ``bins`` equal bins
    between ``lo`` and ``hi`` (the ends clamped into the first and last).
    The bin indices of about ``chunk`` elements at a time go to one
    ``torch.bincount``, which reads its input's range back to the host:
    one wait for the device per chunk rather than per tensor."""
    span = torch.clamp(hi - lo, min=1e-12)
    counts = torch.zeros(bins, dtype=torch.int64, device=lo.device)
    pending, size = [], 0
    for i, t in enumerate(tensors):
        pending.append(((t.detach().float().reshape(-1) - lo) / span
                        * bins).to(torch.int32).clamp(0, bins - 1))
        size += pending[-1].numel()
        if size >= chunk or i == len(tensors) - 1:
            counts += torch.bincount(torch.cat(pending), minlength=bins)
            pending, size = [], 0
    return counts


def watch_metrics(named_params: Named, mode: str, bins: int = 64,
                  depth: int = 2) -> Dict[str, torch.Tensor]:
    """The telemetry of ``mode`` over the named parameters and their
    gradients (a parameter without one counts as a zero gradient): the
    norms, and with 'full' the histograms too."""
    named = list(named_params)
    params = [(n, p.detach()) for n, p in named]
    grads = [(n, p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in named]
    out = group_norms(params, "watch/param_norm", depth)
    out.update(group_norms(grads, "watch/grad_norm", depth))
    if mode == "full":
        for name, tree in (("params", params), ("grads", grads)):
            counts, lo, hi = value_histogram([t for _, t in tree], bins)
            out[f"watch_hist/{name}"] = counts
            out[f"watch_hist/{name}_lo"] = lo
            out[f"watch_hist/{name}_hi"] = hi
    return out
