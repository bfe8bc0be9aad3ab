"""Weights made from the seed on the device, in one draw: every
parameter of a ``param_spec`` (reference/model.py) is a slice of one
uniform(-1, 1) tensor scaled to its initial distribution (a Linear's
U(+-1/sqrt(fan_in)); an MLP layer's N(0, 2/fan_in^2) as the uniform of
that variance, its bias 0). The program and the reference get the same
numbers."""

from __future__ import annotations

from typing import Dict

import torch

# sub-streams of one seed: weights, data, noise
STREAMS = {"weights": 0, "data": 1, "noise": 2, "controls": 3}


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one stream of ``seed`` (any whole number)."""
    return (int(seed) * 4 + STREAMS[stream]) % (2 ** 63 - 1)


def make_weights(spec, seed: int, dtype, device) -> Dict[str, torch.Tensor]:
    """{name: tensor in ``dtype``} for every (name, shape, fan_in, init)
    of ``spec``."""
    sizes = [int(torch.Size(shape).numel()) for _, shape, _, _ in spec]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed,
                                                              "weights"))
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    flat.uniform_(-1.0, 1.0, generator=gen)
    out, off = {}, 0
    for (name, shape, fan_in, init), n in zip(spec, sizes):
        w = flat[off:off + n].view(shape)
        off += n
        if init == "zero":
            w.zero_()
        elif init == "kaiming":
            w.mul_(6.0 ** 0.5 / fan_in)
        else:
            w.mul_(fan_in ** -0.5)
        out[name] = w if dtype == torch.float32 else w.to(dtype)
    return out


@torch.no_grad()
def load_into(module: torch.nn.Module, weights, prefix: str = ""):
    """Copy ``weights`` into ``module``'s parameters, name for name and
    shape for shape; raises on any difference."""
    own = dict(module.named_parameters())
    names = {n[len(prefix):] for n in weights if n.startswith(prefix)}
    if set(own) != names:
        raise ValueError(f"the program's parameters differ from the "
                         f"reference's: {sorted(set(own) ^ names)[:6]}")
    for n, p in own.items():
        w = weights[prefix + n]
        if tuple(w.shape) != tuple(p.shape):
            raise ValueError(f"{n}: shape {tuple(p.shape)} against the "
                             f"reference's {tuple(w.shape)}")
        p.copy_(w)
