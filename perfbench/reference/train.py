"""The training reference: the models' rectified-flow loss, its
gradients and the Muon + AdamW update, in float32 with TF32 off (or the
fp8 control), step by step from the benchmark's weights, batches and
draws.

Each step draws, from a generator set to the program's state for that
step, what the published loss draws in its order: the CFG dropout's
uniform per row (rows whose draw is at most ``cfg_prob`` lose their
controls), sigmoid-normal timesteps per frame, the video noise, then
the audio noise. The latents enter the model in bfloat16 after division
by their VAE scales; the target is noise minus latents; the loss is the
mean squared error (video plus audio for the AV model). After each
step the float32 EMA of the parameters moves as the published trainer's
does: ema <- 0.999 ema + 0.001 p.
"""

from __future__ import annotations

import torch

from .model import Model, Prec, param_spec, train_attend
from .optim import Optimizer

EMA_BETA = 0.999


def bf(x):
    return x.to(torch.bfloat16).float()


def loss_of(model, mc, tc, batch, gen, device, precision, rows=None):
    """The step's loss; ``rows`` (a slice) keeps those batch rows after
    every draw is made for the whole batch (a planted fault)."""
    audio = mc.get("has_audio", False)
    dev = torch.device(device)
    t = [torch.as_tensor(a).to(dev) for a in batch]
    if audio:
        vid, aud, mouse, btn = t[:4]
        doc = None
    else:
        vid, mouse, btn = t[:3]
        doc = t[3] if len(t) > 3 else None
    b, n = vid.shape[:2]
    x = bf(vid / tc["vae_scale"])
    cfg_prob = mc.get("cfg_prob", 0.0)
    hc = torch.ones(b, dtype=torch.bool, device=dev)
    if cfg_prob > 0:
        u = torch.rand(b, generator=gen, device=dev)
        hc = ~(u <= torch.tensor(cfg_prob, dtype=torch.float32, device=dev))
    ts = torch.sigmoid(torch.randn(b, n, generator=gen, device=dev))
    zv = torch.randn(x.shape, generator=gen, device=dev)
    za = None
    if audio:
        a = bf(aud / tc.get("audio_vae_scale", tc["vae_scale"]))
        za = torch.randn(a.shape, generator=gen, device=dev)
    if rows is not None:
        x, zv, ts, hc, mouse, btn = (v[rows] for v in (x, zv, ts, hc, mouse,
                                                         btn))
        if audio:
            a, za = a[rows], za[rows]
        doc = None if doc is None else doc[rows]
    te = ts[:, :, None, None, None]
    lv = x * (1 - te) + zv * te
    L = n * mc["tokens_per_frame"]
    attend = train_attend(mc, L, doc, Prec(precision), dev)
    if not audio:
        pred = model.video(bf(lv), bf(ts), mouse, btn, hc, attend)
        return torch.square(pred - (zv - x)).mean()
    la = a * (1 - ts[:, :, None]) + za * ts[:, :, None]
    pv, pa = model.av(bf(lv), bf(la), bf(ts), mouse, btn, hc, attend)
    return torch.square(pv - (zv - x)).mean() + \
        torch.square(pa - (za - a)).mean()


def run(mc, tc, seed, batches, gen_states, precision, device,
        remat=False, rows=None, update=True):
    """The reference's steps over ``batches``, each drawing from a
    generator set to its state in ``gen_states`` (or, where that is one
    generator, from it in turn): {"losses": [...], "grad1": {name:
    norm}, "change": {name: norm after the last step}, "ema": {name: norm
    of the EMA's change}}. Without ``update`` the parameters and their
    EMA never change (a planted fault: only the first step's gradient
    is taken)."""
    from perfbench.weights import make_weights
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = param_spec(mc, "core.")
    params = make_weights(spec, seed, torch.float32, device)
    p0 = {k: v.clone() for k, v in params.items()}
    ema = {k: v.clone() for k, v in params.items()}
    for v in params.values():
        v.requires_grad_(True)
    model = Model(mc, params, prefix="core.", precision=precision,
                  remat=remat)
    opt = Optimizer(params, tc["opt_kwargs"])
    losses, grad1 = [], None
    names = list(params)
    chained = len(gen_states) == 1 and isinstance(gen_states[0],
                                                  torch.Generator)
    for i, batch in enumerate(batches):
        if chained:
            gen = gen_states[0]
        else:
            gen = torch.Generator(device=device)
            gen.set_state(gen_states[i])
        if i and not update:
            with torch.no_grad():
                losses.append(float(loss_of(model, mc, tc, batch, gen,
                                            device, precision, rows)))
            continue
        loss = loss_of(model, mc, tc, batch, gen, device, precision, rows)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        losses.append(float(loss.detach()))
        g = dict(zip(names, grads))
        if i == 0:
            grad1 = {k: float(v.norm()) for k, v in g.items()}
        if update:
            opt.step(g)
            with torch.no_grad():
                for k in names:
                    ema[k].mul_(EMA_BETA).add_(params[k] * (1.0 - EMA_BETA))
        del g, grads, loss
    with torch.no_grad():
        change = {k: float((params[k] - p0[k]).norm()) for k in names}
        ema = {k: float((ema[k] - p0[k]).norm()) for k in names}
    return {"losses": losses, "grad1": grad1, "change": change, "ema": ema}
