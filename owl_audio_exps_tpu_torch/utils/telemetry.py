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
device tensors: no value is read back to the host here.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch

Named = Iterable[Tuple[str, torch.Tensor]]


def _groups(named: Named, depth: int) -> Dict[str, List[torch.Tensor]]:
    groups: Dict[str, List[torch.Tensor]] = {}
    for name, t in named:
        key = "/".join(name.split(".")[:depth]) or "root"
        groups.setdefault(key, []).append(t)
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
    lo = torch.stack([t.detach().float().amin() for t in tensors]).amin()
    hi = torch.stack([t.detach().float().amax() for t in tensors]).amax()
    span = torch.clamp(hi - lo, min=1e-12)
    counts = torch.zeros(bins, dtype=torch.int64, device=lo.device)
    for t in tensors:
        idx = ((t.detach().float().reshape(-1) - lo) / span * bins).to(
            torch.int32).clamp(0, bins - 1)
        counts += torch.bincount(idx, minlength=bins)
    return counts.to(torch.int32), lo, hi


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
