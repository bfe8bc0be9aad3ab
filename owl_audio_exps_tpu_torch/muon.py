"""Muon (Newton-Schulz-5 orthogonalized momentum) and AdamW, combined by
parameter name (counterpart of owl_audio_exps_tpu/muon.py).

``init_muon`` builds the combined optimizer: AdamW for the parameters
whose name contains one of ``adamw_keys`` and for every parameter of
fewer than two dims, Muon for the other matrices. The update rules are
the JAX package's, step for step, so one step from the same state gives
the same parameters:

* Muon: buf <- lerp(buf, g, 1 - momentum) (rounded to ``momentum_dtype``
  when set), g' <- nesterov ? lerp(g, buf, momentum) : buf,
  o <- NS5(g') in bf16, p <- p - lr * wd * p - lr * max(1, in/out)^0.5 * o.
  The JAX package orthogonalizes its [in, out] kernels; the port's
  weights are the transposed [out, in], so NS5 runs on the transpose and
  the scale reads in/out, which keeps the bf16 rounding the same.
* AdamW: both moments stored in ``state_dtype`` (bf16 when the config
  sets ``momentum_dtype``, as the JAX package's ``adamw_lowmem``; else
  float32, as ``optax.adamw``), the update in float32.

NS5's products are plain ``torch.matmul`` (the JAX package leaves them to
XLA). The optimizers update in place, with ``torch.no_grad``.

The update is enqueued a group of tensors at a time, with no host sync.
The parameters whole on this rank (``groupable``) are grouped by device
and dtypes, Muon's by shape too, and each group is cut into chunks of at
most ``CHUNK_ELEMENTS`` elements, which bounds the temporaries. Each
operation of the per-tensor chain runs once over a chunk's list
(``torch._foreach_*``), in the chain's order and dtypes, so AdamW's
results are the per-tensor chain's bit for bit; NS5 runs once on the
chunk's stacked matrices. AdamW's bias corrections reach the list
operations as Python floats holding the float32 values. A sharded or
staged parameter takes the same chain alone (the per-tensor loop). The
module counters ``grouped`` and ``looped`` count the parameters updated
each way.

Under the fsdp and tensor axes (parallel/sharding.py) a parameter, its
gradient and its moments are this rank's slice. AdamW is elementwise and
runs on the slices; Muon gathers the momentum-updated gradient over the
axes that shard it, runs NS5 on the whole matrix as one process does,
and keeps this rank's slice of the result (every rank orthogonalizes
every matrix; the JAX package's GSPMD runs NS5 on the logical matrix).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple, Union

import torch

from .parallel.mesh import get_mesh
from .parallel.sharding import (gather_tensor, mesh_coords_of, spec_of,
                                stage_of)

# parameters updated through the grouped path and through the per-tensor
# loop since import (always on)
grouped = 0
looped = 0

# the most elements a chunk of a group holds (a larger tensor goes alone):
# each float32 temporary of a chunk's list operations is at most 128 MB,
# and an update at av_v5's widths allocates ~640 MB above its start
CHUNK_ELEMENTS = 1 << 25


def as_dtype(dtype) -> Optional[torch.dtype]:
    """A config's dtype name ("bfloat16") or a torch dtype, or None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


def zeropower_via_newtonschulz5(G: torch.Tensor, steps: int = 5) -> torch.Tensor:
    """Quintic Newton-Schulz orthogonalization of a matrix, bf16 compute
    (the public Muon algorithm)."""
    if G.ndim < 2:
        raise ValueError("NS5 orthogonalizes matrices")
    a, b, c = 3.4445, -4.7750, 2.0315
    X = G.to(torch.bfloat16)
    transposed = G.shape[-2] > G.shape[-1]
    if transposed:
        X = X.mT
    norm = X.float().norm(dim=(-2, -1), keepdim=True).to(torch.bfloat16)
    X = X / (norm + 1e-7)
    for _ in range(steps):
        A = X @ X.mT
        B = b * A + c * (A @ A)
        X = a * X + B @ X
    if transposed:
        X = X.mT
    return X


def groupable(p: torch.Tensor) -> bool:
    """Whether ``p`` takes the grouped update: it is whole on this rank
    (no ShardSpec, or one that shards nothing) and on every pipeline
    stage. Others (Muon's gather and shard) take the per-tensor loop."""
    spec = spec_of(p)
    return (spec is None or not spec.sharded) and stage_of(p) is None


def chunks(items, key: Callable, numel: Callable):
    """``items`` grouped by ``key`` (first-seen order), each group cut in
    order into chunks of at most ``CHUNK_ELEMENTS`` elements by ``numel``
    (an item larger than that alone): yields lists."""
    groups: Dict = {}
    for item in items:
        groups.setdefault(key(item), []).append(item)
    for group in groups.values():
        chunk, size = [], 0
        for item in group:
            n = numel(item)
            if chunk and size + n > CHUNK_ELEMENTS:
                yield chunk
                chunk, size = [], 0
            chunk.append(item)
            size += n
        yield chunk


def _count(n_grouped: int, n_looped: int):
    global grouped, looped
    grouped += n_grouped
    looped += n_looped


class Muon(torch.optim.Optimizer):
    """Muon on 2-D weights in the torch [out, in] layout; the step is the
    full parameter delta (decay + orthogonalized step)."""

    def __init__(self, params, lr: float, momentum: float = 0.95,
                 nesterov: bool = True, ns_steps: int = 5,
                 weight_decay: float = 0.01, momentum_dtype=None):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      nesterov=nesterov, ns_steps=ns_steps,
                                      weight_decay=weight_decay))
        self.momentum_dtype = as_dtype(momentum_dtype)

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            live = [p for p in group["params"] if p.grad is not None]
            for p in live:
                if p.ndim != 2:
                    raise NotImplementedError(
                        f"Muon takes 2-D weights, got shape {tuple(p.shape)}")
                state = self.state[p]
                if "momentum" not in state:
                    state["momentum"] = torch.zeros_like(
                        p, dtype=self.momentum_dtype or p.dtype)
            whole = [p for p in live if groupable(p)]
            for chunk in chunks(whole, lambda p: (
                    p.device, p.shape, p.dtype, p.grad.dtype,
                    self.state[p]["momentum"].dtype), lambda p: p.numel()):
                self._update(chunk, group)
            for p in live:
                if not groupable(p):
                    self._update([p], group)
            _count(len(whole), len(live) - len(whole))

    def _update(self, params, group):
        """One step of ``params``: matrices of one shape, dtypes and
        device, or one sharded matrix, whose NS5 runs on the matrix
        gathered over the axes that shard it."""
        lr, mom = group["lr"], group["momentum"]
        wd = group["weight_decay"]
        grads = [p.grad for p in params]
        states = [self.state[p] for p in params]
        bufs = [s["momentum"].to(g.dtype) for s, g in zip(states, grads)]
        new_bufs = torch._foreach_sub(grads, bufs)
        torch._foreach_mul_(new_bufs, 1.0 - mom)
        torch._foreach_add_(new_bufs, bufs)
        del bufs
        if self.momentum_dtype is not None:
            new_bufs = [b.to(self.momentum_dtype) for b in new_bufs]
        gm = [b.to(g.dtype) for b, g in zip(new_bufs, grads)]
        if group["nesterov"]:
            gm = torch._foreach_sub(gm, grads)
            torch._foreach_mul_(gm, mom)
            torch._foreach_add_(gm, grads)
        spec = spec_of(params[0])
        full = [gather_tensor(x, spec) for x in gm]
        del gm
        # NS5 of the transposes [in, out], which it turns to [min, max]:
        # stacked so that this is row-major (the same values, faster
        # products), then back to the [out, in] layout
        n_out, n_in = full[0].shape
        G = (torch.stack(full).mT if n_in > n_out
             else torch.stack([x.mT for x in full]))
        del full
        o = zeropower_via_newtonschulz5(G, group["ns_steps"]).mT.to(
            params[0].dtype, memory_format=torch.contiguous_format)
        del G
        shape = params[0].shape
        if spec is not None and spec.sharded:
            o = spec.shard(o[0], mesh_coords_of(get_mesh()))[None]
            shape = spec.shape
        scale = max(1.0, shape[1] / shape[0]) ** 0.5
        o.mul_(lr * scale)
        delta = torch._foreach_mul(params, -(lr * wd))
        torch._foreach_sub_(delta, list(o.unbind(0)))
        del o
        torch._foreach_add_(params, delta)
        for s, b in zip(states, new_bufs):
            s["momentum"] = b

    def load_state_dict(self, state_dict):
        # torch casts loaded state to the parameter's dtype; the momentum
        # keeps its own
        super().load_state_dict(state_dict)
        _cast_state(self, self.momentum_dtype)


def _cast_state(opt: torch.optim.Optimizer, dtype: Optional[torch.dtype]):
    if dtype is None:
        return
    for state in opt.state.values():
        for key, value in state.items():
            if torch.is_tensor(value) and value.is_floating_point():
                state[key] = value.to(dtype)


LR = Union[float, Callable[[int], float]]


class AdamW(torch.optim.Optimizer):
    """AdamW with both moments stored in ``state_dtype`` (the parameter's
    dtype when None); the update runs in float32. ``lr`` is a number or a
    schedule of the step count (0 for the first step)."""

    def __init__(self, params, lr: LR, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.01,
                 state_dtype=None):
        # a schedule lives on the optimizer, not in the (saved) groups
        self.schedule = lr if callable(lr) else None
        super().__init__(params, dict(lr=0.0 if callable(lr) else lr,
                                      betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay, count=0))
        self.state_dtype = as_dtype(state_dtype)

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            group["count"] += 1
            count = group["count"]
            lr = (float(self.schedule(count - 1)) if self.schedule
                  else group["lr"])
            # bias corrections in float32, as the JAX package computes
            # them; the list operations take them as Python floats, which
            # hold the float32 values exactly
            c1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** count)
            c2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** count)
            live = [p for p in group["params"] if p.grad is not None]
            for p in live:
                state = self.state[p]
                if "mu" not in state:
                    dt = self.state_dtype or p.dtype
                    state["mu"] = torch.zeros_like(p, dtype=dt)
                    state["nu"] = torch.zeros_like(p, dtype=dt)
            whole = [p for p in live if groupable(p)]
            for chunk in chunks(whole, lambda p: (
                    p.device, p.dtype, self.state[p]["mu"].dtype),
                    lambda p: p.numel()):
                self._update(chunk, group, lr, c1, c2)
            for p in live:
                if not groupable(p):
                    self._update([p], group, lr, c1, c2)
            _count(len(whole), len(live) - len(whole))

    def _update(self, params, group, lr, c1, c2):
        """The step of ``params`` (one device and dtypes): the float32
        chain mu <- b1 mu + (1 - b1) g, nu <- b2 nu + (1 - b2) g g,
        p <- p - lr (mu / c1 / (sqrt(nu / c2) + eps) + wd p), each
        operation over the list."""
        b1, b2 = group["betas"]
        states = [self.state[p] for p in params]
        mus = [s["mu"] for s in states]
        nus = [s["nu"] for s in states]
        g32 = [p.grad.float() for p in params]
        m = torch._foreach_mul([x.float() for x in mus], b1)
        t = torch._foreach_mul(g32, 1 - b1)
        torch._foreach_add_(m, t)
        torch._foreach_copy_(mus, m)
        # a list of scalars: the card divides by each (a single scalar
        # would be multiplied by its reciprocal)
        upd = torch._foreach_div(m, [c1] * len(m))
        del m
        v = torch._foreach_mul([x.float() for x in nus], b2)
        t = torch._foreach_mul(g32, 1 - b2)
        torch._foreach_mul_(t, g32)
        torch._foreach_add_(v, t)
        del t, g32
        torch._foreach_copy_(nus, v)
        torch._foreach_div_(v, [c2] * len(v))
        torch._foreach_sqrt_(v)
        torch._foreach_add_(v, group["eps"])
        torch._foreach_div_(upd, v)
        del v
        decay = torch._foreach_mul([p.float() for p in params],
                                   group["weight_decay"])
        torch._foreach_add_(upd, decay)
        del decay
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(params, [u.to(p.dtype)
                                     for u, p in zip(upd, params)])

    def load_state_dict(self, state_dict):
        # torch casts loaded state to the parameter's dtype; the moments
        # keep their own
        super().load_state_dict(state_dict)
        _cast_state(self, self.state_dtype)


def muon_adamw_labels(named_params: Iterable[Tuple[str, torch.Tensor]],
                      adamw_keys=None) -> Dict[str, str]:
    """{name: 'adamw' | 'muon'}: 'adamw' for keyed / <2-D params. Every
    AdamW key must match at least one parameter name."""
    adamw_keys = list(adamw_keys or [])
    named = list(named_params)
    labels = {name: ("adamw" if p.ndim < 2
                     or any(k in name for k in adamw_keys) else "muon")
              for name, p in named}
    for k in adamw_keys:
        if not any(k in name for name, _ in named):
            raise ValueError(f"AdamW key {k!r} not found in model parameters")
    return labels


class CombinedOptimizer:
    """Muon for the 'muon'-labelled parameters, AdamW for the rest."""

    def __init__(self, muon: Optional[Muon], adamw: Optional[AdamW],
                 labels: Dict[str, str]):
        self.muon, self.adamw, self.labels = muon, adamw, labels

    def _parts(self):
        return [o for o in (self.muon, self.adamw) if o is not None]

    def step(self):
        for opt in self._parts():
            opt.step()

    def zero_grad(self, set_to_none: bool = True):
        for opt in self._parts():
            opt.zero_grad(set_to_none=set_to_none)

    def state_dict(self):
        return {"muon": None if self.muon is None else self.muon.state_dict(),
                "adamw": None if self.adamw is None
                else self.adamw.state_dict()}

    def load_state_dict(self, state):
        for name, opt in (("muon", self.muon), ("adamw", self.adamw)):
            if opt is not None:
                opt.load_state_dict(state[name])


def init_muon(named_params, lr: float = 1e-3, momentum: float = 0.95,
              adamw_lr: float = 1e-4, adamw_wd: float = 1e-4,
              adamw_eps: float = 1e-15, adamw_betas=(0.9, 0.999),
              adamw_keys=None, weight_decay: float = 0.01,
              momentum_dtype=None, **_) -> CombinedOptimizer:
    """Combined Muon + AdamW over ``named_params`` (name, parameter)."""
    named = list(named_params)
    labels = muon_adamw_labels(named, adamw_keys)
    muon_p = [p for n, p in named if labels[n] == "muon"]
    adamw_p = [p for n, p in named if labels[n] == "adamw"]
    muon = (Muon(muon_p, lr, momentum, weight_decay=weight_decay,
                 momentum_dtype=momentum_dtype) if muon_p else None)
    adamw = (AdamW(adamw_p, adamw_lr, betas=tuple(adamw_betas), eps=adamw_eps,
                   weight_decay=adamw_wd, state_dtype=momentum_dtype)
             if adamw_p else None)
    return CombinedOptimizer(muon, adamw, labels)
