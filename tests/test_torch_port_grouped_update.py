"""The optimizer update as grouped list operations (muon.py, the EMA and
the parameter norm of trainers/base.py) against the per-tensor loop it
replaced, which this file keeps as its reference.

AdamW, the EMA and the clip run the loop's operations in its order and
dtypes, so they equal it bit for bit. NS5 runs once on a stack of the
matrices of one shape: held to the 1e-1 relative limit of NS5's bf16
rounding (ROADMAP, "Muon's NS5 runs in bf16"); on the CPU it reads 0.
The norm sums per-tensor norms: 1e-6 relative.

The tests marked ``cuda`` skip without a GPU; this file imports no JAX,
so on the card run it as

    python3 -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_port_grouped_update.py
"""

import copy
from pathlib import Path

import pytest
import torch

from owl_audio_exps_tpu_torch import muon
from owl_audio_exps_tpu_torch.trainers.base import (clip_grad_norm,
                                                    ema_update, global_norm)

NS5_REL = 1e-1
NORM_REL = 1e-6
KEYS = ["adaln", "proj_in"]
KW = dict(lr=1e-3, momentum=0.95, adamw_lr=1e-3, adamw_wd=1e-4,
          adamw_eps=1e-15, adamw_betas=(0.9, 0.95), adamw_keys=KEYS)


# ------------------------------------------------------ the reference loop

class RefMuon(muon.Muon):
    """Muon's step one tensor at a time, as before the grouped update."""

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            lr, mom = group["lr"], group["momentum"]
            wd = group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if "momentum" not in state:
                    state["momentum"] = torch.zeros_like(
                        p, dtype=self.momentum_dtype or p.dtype)
                buf = state["momentum"].to(g.dtype)
                new_buf = buf + (1.0 - mom) * (g - buf)
                if self.momentum_dtype is not None:
                    new_buf = new_buf.to(self.momentum_dtype)
                buf_g = new_buf.to(g.dtype)
                gm = g + mom * (buf_g - g) if group["nesterov"] else buf_g
                o = muon.zeropower_via_newtonschulz5(
                    gm.mT, group["ns_steps"]).to(p.dtype).mT
                scale = max(1.0, p.shape[1] / p.shape[0]) ** 0.5
                p.add_(-(lr * wd) * p - (lr * scale) * o)
                state["momentum"] = new_buf


class RefAdamW(muon.AdamW):
    """AdamW's step one tensor at a time, the bias corrections copied to
    the device, as before the grouped update."""

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            group["count"] += 1
            count = group["count"]
            lr = (float(self.schedule(count - 1)) if self.schedule
                  else group["lr"])
            c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** count
            c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** count
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if "mu" not in state:
                    dt = self.state_dtype or p.dtype
                    state["mu"] = torch.zeros_like(p, dtype=dt)
                    state["nu"] = torch.zeros_like(p, dtype=dt)
                g32 = p.grad.float()
                mu32 = state["mu"].float() * b1 + (1 - b1) * g32
                nu32 = state["nu"].float() * b2 + (1 - b2) * g32 * g32
                c1d, c2d = c1.to(p.device), c2.to(p.device)
                upd = mu32 / c1d / (torch.sqrt(nu32 / c2d) + group["eps"])
                p.add_((-lr * (upd + group["weight_decay"] * p.float())
                        ).to(p.dtype))
                state["mu"].copy_(mu32)
                state["nu"].copy_(nu32)


def ref_init_muon(named, momentum_dtype=None):
    labels = muon.muon_adamw_labels(named, KEYS)
    mp = [p for n, p in named if labels[n] == "muon"]
    ap = [p for n, p in named if labels[n] == "adamw"]
    return muon.CombinedOptimizer(
        RefMuon(mp, KW["lr"], KW["momentum"], momentum_dtype=momentum_dtype),
        RefAdamW(ap, KW["adamw_lr"], betas=KW["adamw_betas"],
                 eps=KW["adamw_eps"], weight_decay=KW["adamw_wd"],
                 state_dtype=momentum_dtype), labels)


@torch.no_grad()
def ref_ema(ema, named, beta=0.999):
    for name, p in named:
        e = ema[name]
        e.mul_(beta).add_(p.to(e.dtype) * (1.0 - beta))


def ref_norm(tensors):
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


# ------------------------------------------------------------- the model

# Muon shape groups of several matrices and of one, tall, wide and square;
# AdamW matrices (by key) and vectors
SHAPES = {
    "blocks.0.qkv.weight": (48, 16), "blocks.1.qkv.weight": (48, 16),
    "blocks.2.qkv.weight": (48, 16), "blocks.0.out.weight": (16, 16),
    "blocks.1.out.weight": (16, 16), "blocks.0.fc1.weight": (40, 16),
    "blocks.0.fc2.weight": (16, 40), "head.weight": (7, 16),
    "blocks.0.adaln.weight": (96, 16), "blocks.1.adaln.weight": (96, 16),
    "proj_in.weight": (16, 12), "blocks.0.qkv.bias": (48,),
    "blocks.1.qkv.bias": (48,), "blocks.0.norm.weight": (16,),
    "head.bias": (7,)}


def make_params(device="cpu", seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return {n: torch.nn.Parameter(0.1 * torch.randn(
        s, generator=gen, device=device)) for n, s in SHAPES.items()}


def set_grads(named, step, device="cpu"):
    gen = torch.Generator(device=device).manual_seed(100 + step)
    for _, p in named:
        p.grad = torch.randn(p.shape, generator=gen, device=device)


def rel(a, b, base):
    return ((a.float() - b.float()).norm() / base.float().norm()).item()


def run_both(device="cpu", momentum_dtype=None, ema_dtype=None, steps=3,
             tag=None):
    """``steps`` steps of the grouped update and of the reference loop
    from the same parameters and gradients; checks every result."""
    p0 = make_params(device)
    mine, ref = copy.deepcopy(p0), copy.deepcopy(p0)
    for d in (mine, ref):
        for n, s in (tag or {}).items():
            setattr(d[n], *s)
    named, rnamed = list(mine.items()), list(ref.items())
    opt = muon.init_muon(named, momentum_dtype=momentum_dtype, **KW)
    ropt = ref_init_muon(rnamed, momentum_dtype)
    dt = ema_dtype or torch.float32
    ema = {n: p.detach().clone().to(dt) for n, p in named}
    rema = copy.deepcopy(ema)
    # the reference EMA of the grouped path's own parameters: the EMA is
    # held bit for bit whatever NS5's roundings
    same = copy.deepcopy(ema)
    counts = muon.grouped, muon.looped
    for step in range(steps):
        set_grads(named, step, device)
        set_grads(rnamed, step, device)
        opt.step()
        ropt.step()
        ema_update(ema, named, 0.999)
        ref_ema(same, named)
        ref_ema(rema, rnamed)
        norm = global_norm([p for _, p in named])
        want = ref_norm([p for _, p in named])
        assert abs(norm.item() - want.item()) <= NORM_REL * want.item()
    for name, p in named:
        r = ref[name]
        assert torch.equal(ema[name], same[name]), name
        if opt.labels[name] == "adamw":
            assert torch.equal(p, r), name
            for k in ("mu", "nu"):
                a, b = opt.adamw.state[p][k], ropt.adamw.state[r][k]
                assert a.dtype == b.dtype == (momentum_dtype or p.dtype)
                assert torch.equal(a, b), (name, k)
            assert torch.equal(ema[name], rema[name]), name
        else:
            change = r.detach() - p0[name].detach()
            assert rel(p, r, change) < NS5_REL, name
            a, b = opt.muon.state[p]["momentum"], ropt.muon.state[r]["momentum"]
            assert a.dtype == b.dtype
            assert rel(a, b, b) < NS5_REL, name
            assert rel(ema[name] - p0[name], rema[name] - p0[name],
                       rema[name] - p0[name]) < NS5_REL, name
    return (muon.grouped - counts[0], muon.looped - counts[1]), opt, ropt


# ------------------------------------------------------------- CPU tests

@pytest.mark.parametrize("chunk", [muon.CHUNK_ELEMENTS, 800])
@pytest.mark.parametrize("momentum_dtype,ema_dtype", [
    (None, None), ("bfloat16", None), ("bfloat16", torch.bfloat16)])
def test_grouped_update_matches_the_per_tensor_loop(
        monkeypatch, chunk, momentum_dtype, ema_dtype):
    """Three steps: AdamW's parameters and moments and the EMA equal the
    loop's bit for bit, Muon's parameters and momentum within NS5's
    limit, the norm within 1e-6; chunks of 800 elements cut every Muon
    group of several matrices into chunks of one or two and put the
    largest tensors alone. Every parameter takes the grouped path."""
    monkeypatch.setattr(muon, "CHUNK_ELEMENTS", chunk)
    counted, _, _ = run_both(momentum_dtype=torch.bfloat16 if momentum_dtype
                             else None, ema_dtype=ema_dtype)
    assert counted == (3 * len(SHAPES), 0)


class WholeShard:
    """A stand-in ShardSpec for one process: it says it shards, while
    gather and shard hand back the whole tensor."""

    sharded = True

    def __init__(self, shape):
        self.shape = tuple(shape)

    def gather(self, t, mesh):
        return t

    def shard(self, full, coords):
        return full.contiguous()


def test_sharded_and_staged_parameters_take_the_loop():
    """A parameter with a ShardSpec that shards, or with a pipeline stage,
    takes the per-tensor loop (Muon's gather and shard); the others the
    grouped path. The results are the same as the loop's."""
    tag = {"blocks.0.qkv.weight": ("shard_spec", WholeShard((48, 16))),
           "blocks.1.adaln.weight": ("shard_spec", WholeShard((96, 16))),
           "blocks.1.out.weight": ("pipe_stage", 0),
           "head.bias": ("pipe_stage", 1)}
    (g, lo), _, _ = run_both(tag=tag)
    assert (g, lo) == (3 * (len(SHAPES) - 4), 3 * 4)
    p = torch.nn.Parameter(torch.ones(4, 4))
    assert muon.groupable(p)
    p.shard_spec = WholeShard((8, 4))
    assert not muon.groupable(p)
    p.shard_spec.sharded = False
    assert muon.groupable(p)
    p.pipe_stage = 0
    assert not muon.groupable(p)


def test_reference_state_loads_and_continues():
    """An optimizer state saved by the per-tensor loop (a checkpoint
    written before the grouped update) loads into the grouped optimizer,
    which continues as the loop does."""
    p0 = make_params()
    ref = copy.deepcopy(p0)
    rnamed = list(ref.items())
    ropt = ref_init_muon(rnamed, torch.bfloat16)
    for step in range(2):
        set_grads(rnamed, step)
        ropt.step()
    saved = copy.deepcopy(ropt.state_dict())
    mine = copy.deepcopy(ref)
    named = list(mine.items())
    opt = muon.init_muon(named, momentum_dtype=torch.bfloat16, **KW)
    opt.load_state_dict(saved)
    assert opt.adamw.param_groups[0]["count"] == 2
    set_grads(named, 2)
    set_grads(rnamed, 2)
    opt.step()
    ropt.step()
    for name, p in named:
        r = ref[name]
        if opt.labels[name] == "adamw":
            assert torch.equal(p, r), name
            assert torch.equal(opt.adamw.state[p]["nu"],
                               ropt.adamw.state[r]["nu"]), name
        else:
            assert rel(p, r, r - p0[name].detach()) < NS5_REL, name
    # and the grouped optimizer's own state saves in the same layout
    sd = opt.state_dict()
    assert sd["adamw"]["param_groups"] == ropt.state_dict()[
        "adamw"]["param_groups"]
    assert {k: sorted(v) for k, v in sd["muon"]["state"].items()} == {
        k: sorted(v) for k, v in ropt.state_dict()["muon"]["state"].items()}


@pytest.mark.parametrize("ema_dtype", [torch.float32, torch.bfloat16])
def test_ema_update_matches_the_loop(monkeypatch, ema_dtype):
    """The EMA over lists, cut into chunks of 500 elements, equals the
    per-tensor loop bit for bit over five updates, float32 or bf16."""
    monkeypatch.setattr(muon, "CHUNK_ELEMENTS", 500)
    named = list(make_params().items())
    ema = {n: (p.detach() + 1).to(ema_dtype) for n, p in named}
    want = copy.deepcopy(ema)
    for step in range(5):
        with torch.no_grad():
            for _, p in named:
                p.add_(0.5 * torch.randn_like(p))
        ema_update(ema, named, 0.999)
        ref_ema(want, named)
    for n in ema:
        assert ema[n].dtype == ema_dtype
        assert torch.equal(ema[n], want[n]), n


def test_norm_and_clip_match_the_loop():
    """global_norm over float32 and bf16 tensors within 1e-6 of the loop's
    float32 sum of squares; the clip scales every gradient as the loop
    did."""
    gen = torch.Generator().manual_seed(3)
    ts = [torch.randn(s, generator=gen) * 7 for s in SHAPES.values()]
    ts += [torch.randn(33, 5, generator=gen).to(torch.bfloat16)]
    got, want = global_norm(ts).item(), ref_norm(ts).item()
    assert abs(got - want) <= NORM_REL * want
    params = [torch.nn.Parameter(t.clone()) for t in ts]
    for p, t in zip(params, ts):
        p.grad = 10 * t
    grads = [p.grad.clone() for p in params]
    norm = clip_grad_norm(params, 10.0)
    scale = torch.clamp(10.0 / (norm + 1e-6), max=1.0)
    for p, g in zip(params, grads):
        assert torch.equal(p.grad, g.mul_(scale))


def test_chunks_cut_groups_in_order(monkeypatch):
    """Items group by key in first-seen order, each group cut in order at
    ``CHUNK_ELEMENTS``; an item larger than that goes alone."""
    monkeypatch.setattr(muon, "CHUNK_ELEMENTS", 10)
    items = [("a", 4), ("b", 3), ("a", 4), ("a", 4), ("b", 20), ("a", 12),
             ("b", 3)]
    got = list(muon.chunks(items, lambda it: it[0], lambda it: it[1]))
    assert got == [[("a", 4), ("a", 4)], [("a", 4)], [("a", 12)],
                   [("b", 3)], [("b", 20)], [("b", 3)]]


# ------------------------------------------------------------ card tests

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the test reads the card's syncs, "
                    "roundings or memory")


def _av_trainer(opt="Muon", **model):
    """A BaseTrainer and its state on the card over configs/av_v5's model
    (``model`` overrides its keys), parameters drawn N(0, 0.02)."""
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.models import get_model_cls
    from owl_audio_exps_tpu_torch.trainers.base import BaseTrainer
    base = Config.from_yaml(str(Path(__file__).resolve().parents[1]
                                / "configs" / "av_v5_8x8_weak.yml"))
    mc = dict(base.model.to_dict(), **model)
    tc = base.train.to_dict()
    if opt != "Muon":
        tc.update(opt=opt, opt_kwargs={"lr": 1e-4})
    cfg = Config.from_dict({"model": mc, "train": tc})
    trainer = BaseTrainer(cfg, device="cuda")
    m = get_model_cls(mc["model_id"])(cfg.model, dtype=torch.bfloat16,
                                      device="cuda", seed=None)
    with torch.no_grad():
        for p in m.parameters():
            p.normal_(0.0, 0.02)
    return trainer, trainer.make_state(m)


def _grads(model, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for p in model.parameters():
        p.grad = 1e-3 * torch.randn(p.shape, generator=gen, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("opt,clip", [("Muon", None), ("AdamW", 10.0)])
def test_update_makes_no_host_sync_on_card(opt, clip):
    """Two updates of a small AV-shaped model (the first makes the
    optimizer's states) under ``set_sync_debug_mode("error")``: the
    optimizer, the clip, the parameter norm and the EMA wait for nothing
    on the card."""
    _need_card()
    trainer, state = _av_trainer(opt, n_layers=2, d_model=256, n_heads=4)
    before = muon.grouped, muon.looped
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        for step in range(2):
            _grads(state.model, step)
            metrics = {}
            trainer.apply_update(state, metrics, clip, step)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    n = sum(1 for _ in state.model.parameters())
    assert (muon.grouped - before[0], muon.looped - before[1]) == (2 * n, 0)
    assert torch.isfinite(metrics["param_norm"]).item()


@pytest.mark.cuda
@pytest.mark.parametrize("momentum_dtype,ema_dtype", [
    (None, None), ("bfloat16", torch.bfloat16)])
def test_grouped_update_matches_the_loop_on_card(momentum_dtype, ema_dtype):
    """The CPU test's comparison on the card: AdamW and the EMA bit for
    bit (the list operations' scalar division is the loop's division by
    a device tensor), Muon within NS5's limit, the norm within 1e-6."""
    _need_card()
    counted, _, _ = run_both("cuda", torch.bfloat16 if momentum_dtype
                             else None, ema_dtype)
    assert counted == (3 * len(SHAPES), 0)


@pytest.mark.cuda
def test_update_memory_stays_under_a_gib_on_card():
    """At av_v5.train.w16b32's widths (configs/av_v5_8x8_weak.yml, 24
    layers of d 1536), with the parameters, gradients, states and EMA
    already allocated, the update's allocations above what it starts
    with stay under 1 GiB."""
    _need_card()
    trainer, state = _av_trainer()
    _grads(state.model, 0)
    trainer.apply_update(state, {}, None, 0)
    _grads(state.model, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    trainer.apply_update(state, {}, None, 1)
    torch.cuda.synchronize()
    above = torch.cuda.max_memory_allocated() - start
    print(f"update transient {above / 2 ** 20:.1f} MiB over "
          f"{start / 2 ** 30:.2f} GiB allocated")
    assert above < 2 ** 30
