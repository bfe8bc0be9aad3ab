"""Plain float32 reference of the optimizer the configurations state:
Muon (Newton-Schulz-5 orthogonalized Nesterov momentum) on the matrices,
AdamW on the vectors and on the parameters named by ``adamw_keys``, as
the published Muon + AdamW split defines them. No gradient clip (the
configurations' optimizer is Muon).
"""

from __future__ import annotations

from typing import Dict

import torch


def labels(spec_names_shapes, adamw_keys) -> Dict[str, str]:
    """{name: "adamw" | "muon"}."""
    keys = list(adamw_keys or [])
    return {n: ("adamw" if len(s) < 2 or any(k in n for k in keys)
                else "muon") for n, s in spec_names_shapes}


def newton_schulz5(g, steps=5):
    """The quintic Newton-Schulz orthogonalization of the public Muon
    algorithm, in float32."""
    a, b, c = 3.4445, -4.7750, 2.0315
    x = g
    tr = x.shape[0] > x.shape[1]
    if tr:
        x = x.T
    x = x / (x.norm() + 1e-7)
    for _ in range(steps):
        A = x @ x.T
        x = a * x + (b * A + c * (A @ A)) @ x
    return x.T if tr else x


class Optimizer:
    """One Muon + AdamW state over the parameter dict; ``step(grads)``
    updates the parameters in place."""

    def __init__(self, params: Dict[str, torch.Tensor], opt_kwargs):
        kw = dict(opt_kwargs)
        self.params = params
        self.lab = labels([(n, tuple(p.shape)) for n, p in params.items()],
                          kw.get("adamw_keys"))
        self.lr = kw.get("lr", 1e-3)
        self.mom = kw.get("momentum", 0.95)
        self.wd = kw.get("weight_decay", 0.01)
        self.alr = kw.get("adamw_lr", 1e-4)
        self.awd = kw.get("adamw_wd", 1e-4)
        self.eps = kw.get("adamw_eps", 1e-15)
        self.b1, self.b2 = kw.get("adamw_betas", (0.9, 0.999))
        self.state: Dict[str, dict] = {}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]):
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for n, p in self.params.items():
            g = grads[n]
            st = self.state.setdefault(n, {})
            if self.lab[n] == "muon":
                buf = st.get("buf", torch.zeros_like(p))
                buf = buf + (1.0 - self.mom) * (g - buf)
                st["buf"] = buf
                o = newton_schulz5(g + self.mom * (buf - g))
                scale = max(1.0, p.shape[1] / p.shape[0]) ** 0.5
                p.add_(-(self.lr * self.wd) * p - (self.lr * scale) * o)
            else:
                mu = st.get("mu", torch.zeros_like(p)) * self.b1 \
                    + (1 - self.b1) * g
                nu = st.get("nu", torch.zeros_like(p)) * self.b2 \
                    + (1 - self.b2) * g * g
                st["mu"], st["nu"] = mu, nu
                upd = mu / c1 / (torch.sqrt(nu / c2) + self.eps)
                p.add_(-self.alr * (upd + self.awd * p))
