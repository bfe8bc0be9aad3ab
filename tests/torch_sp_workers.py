"""Multi-process harness of tests/test_torch_port_context.py: runs a
function in ``world`` spawned processes joined by a gloo process group
(rendezvous through a ``file://`` path under the test's tmp_path, so
parallel test workers never share a port), and the functions those
processes run. Imports no JAX: the children import this module, and the
port stands alone.
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import os
import sys
import traceback

import numpy as np
import torch

TIMEOUT_S = 120


def _child(fn, rank, world, tmp):
    out = os.path.join(tmp, f"rank{rank}.pt")
    try:
        torch.set_num_threads(1)
        args = torch.load(os.path.join(tmp, "args.pt"), weights_only=False)
        from owl_audio_exps_tpu_torch.parallel import dist as pdist
        pdist.init_distributed("cpu", rank=rank, world_size=world,
                               init_method="file://" + os.path.join(
                                   tmp, "rendezvous"))
        try:
            result = fn(rank, world, *args)
        finally:
            pdist.cleanup()
        torch.save({"ok": result}, out)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out)
        raise


def run_ranks(fn, world: int, tmp, *args):
    """fn(rank, world, *args) in ``world`` gloo processes; returns the
    list of their results (torch.save-able), raising on any failure."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    # the arguments go through a file: a spawn start blocks until the
    # child has read what it was handed, so large arguments would start
    # the children one after another
    torch.save(args, os.path.join(tmp, "args.pt"))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(fn, r, world, tmp))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    results = []
    for r, p in enumerate(procs):
        path = os.path.join(tmp, f"rank{r}.pt")
        got = torch.load(path, weights_only=False) if os.path.exists(path) \
            else {"error": f"rank {r} left no result (exit {p.exitcode})"}
        if "error" in got:
            raise RuntimeError(f"rank {r} of {world}:\n{got['error']}")
        results.append(got["ok"])
    return results


@contextlib.contextmanager
def count_ring_partials():
    """Counts the ring partials parallel/context.py runs (calls of its
    K4 entry, ops/splash.py splash_attention_lse) into the yielded
    one-element list."""
    from owl_audio_exps_tpu_torch.parallel import context
    calls = [0]
    orig = context.splash_attention_lse

    def counted(*a, **kw):
        calls[0] += 1
        return orig(*a, **kw)

    context.splash_attention_lse = counted
    try:
        yield calls
    finally:
        context.splash_attention_lse = orig


def _seq_mesh(world):
    from owl_audio_exps_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    return make_mesh(MeshConfig(seq=world), device_type="cpu")


def ring_halo_worker(rank, world, q, k, v, gw, tpf, window):
    """This rank's slice of sp_attention over full numpy q, k, v [B, H, L,
    Dh]: (out, dq, dk, dv) of its slice under the loss sum(out * gw), and
    the number of ring partials run in the forward and in all."""
    from owl_audio_exps_tpu_torch.parallel import context
    mesh = _seq_mesh(world)
    per = q.shape[2] // world
    sl = slice(rank * per, (rank + 1) * per)
    leaves = [torch.from_numpy(np.ascontiguousarray(a[:, :, sl]))
              .requires_grad_() for a in (q, k, v)]
    with count_ring_partials() as calls:
        out = context.sp_attention(*leaves, tpf, window, mesh)
        forward_calls = calls[0]
        (out * torch.from_numpy(gw[:, :, sl])).sum().backward()
    forbidden = [m for m in sys.modules if m.split(".")[0] in
                 ("jax", "jaxlib", "flax", "owl_audio_exps_tpu")]
    return dict(out=out.detach().numpy(),
                grads=[t.grad.numpy() for t in leaves],
                partials_forward=forward_calls, partials_total=calls[0],
                forbidden=forbidden)


def model_worker(rank, world, cfg_kw, state_dict, inputs, draws):
    """The context-parallel GameRFT on this rank: (its share of the loss,
    its slice of the core's prediction) with the draws handed in."""
    from owl_audio_exps_tpu_torch.configs import transformer_config
    from owl_audio_exps_tpu_torch.models.gamerft import GameRFT
    mesh = _seq_mesh(world)
    cfg = transformer_config(**cfg_kw)
    model = GameRFT(cfg, dtype=torch.float32, device="cpu", seed=None)
    model.load_state_dict(state_dict, strict=True)
    x, mouse, btn = (torch.from_numpy(a) for a in inputs)
    ts, z, has = (torch.from_numpy(a) for a in draws)
    with torch.no_grad():
        loss = model(x, mouse, btn, has_controls=has, ts=ts, z=z)
        f0, f1 = mesh.seq_frames(x.shape[1])
        te = ts[:, f0:f1, None, None, None]
        lerpd = x[:, f0:f1] * (1 - te) + z[:, f0:f1] * te
        pred = model.core(lerpd, ts[:, f0:f1], mouse[:, f0:f1],
                          btn[:, f0:f1], has_controls=has, frame_offset=f0)
    return dict(loss=loss.item(), pred=pred.numpy())


def trainer_step_worker(rank, world, cfg_dict, max_steps=1):
    """One RFTTrainer run of ``max_steps`` on this rank, with the mesh of
    the config and the model in float32 (the trainer's own init_state
    computes in bf16); returns the logged losses and the gradients the
    optimizer saw at the first step (after the cross-rank reduction)."""
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.models import get_model_cls
    from owl_audio_exps_tpu_torch.parallel.dist import broadcast_from_main
    from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
    cfg = Config.from_dict(cfg_dict)
    trainer = get_trainer_cls(cfg.train.trainer_id)(cfg, device="cpu")
    seen = {}

    def init_state_spy(seed=0):
        model = get_model_cls(trainer.model_id)(
            trainer.model_cfg, dtype=torch.float32, device="cpu", seed=seed)
        broadcast_from_main(model)
        state = trainer.make_state(model.train())
        step = state.optimizer.step

        def spied():
            if not seen:
                seen.update({n: p.grad.clone() for n, p in
                             state.model.named_parameters()})
            return step()

        state.optimizer.step = spied
        return state

    trainer.init_state = init_state_spy
    with count_ring_partials() as calls:
        state = trainer.train(max_steps=max_steps)
    return dict(losses=[h["diffusion_loss"] for h in trainer.logger.history],
                grads={n: g.numpy() for n, g in seen.items()},
                mesh=(trainer.mesh.data, trainer.mesh.seq),
                step=state.step, accum=trainer.accum_steps(),
                ring_partials=calls[0])


# ------------------------------------------- the fsdp and tensor axes

def _np(t):
    return t.detach().float().cpu().numpy()


def sharded_step(cfg_dict, state_dict, batch, draws):
    """One RFTTrainer.train_step (model in float32) on this rank's rows of
    the batch under the config's mesh, with the draws handed in: the
    logged loss and grad norm, the gradients the optimizer saw and the
    parameters after the step, each gathered to its full shape."""
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.models.gamerft import GameRFT
    from owl_audio_exps_tpu_torch.parallel.sharding import (gather_params,
                                                            gather_tensor,
                                                            spec_of)
    from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
    cfg = Config.from_dict(cfg_dict)
    trainer = get_trainer_cls("rft")(cfg, device="cpu")
    mesh = trainer.mesh
    model = GameRFT(cfg.model, dtype=torch.float32, device="cpu", seed=None)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_dict.items()}, strict=True)
    state = trainer.make_state(model.train())
    per = batch[0].shape[0] // mesh.batch_ranks
    rows = slice(mesh.batch_rank * per, (mesh.batch_rank + 1) * per)
    mb = [torch.from_numpy(np.array(a[rows]))
          for a in tuple(batch) + tuple(draws)]

    def loss_fn(model, mb, generator):
        x, mouse, btn, ts, z, has = mb
        loss = model(x, mouse, btn, ts=ts, z=z, has_controls=has)
        return loss, {"diffusion_loss": loss.detach()}

    trainer.loss_fn = loss_fn
    seen, step = {}, state.optimizer.step

    def spied():
        seen.update({n: _np(gather_tensor(p.grad, spec_of(p), mesh))
                     for n, p in state.model.named_parameters()})
        return step()

    state.optimizer.step = spied
    metrics = trainer.train_step(state, [mb], None,
                                 clip_norm=trainer.grad_clip_norm())
    return dict(loss=float(metrics["diffusion_loss"]),
                grad_norm=float(metrics.get("grad_norm", float("nan"))),
                grads=seen,
                params={n: _np(t) for n, t in
                        gather_params(state.model, mesh).items()},
                local_shapes={n: tuple(p.shape) for n, p in
                              state.model.named_parameters()},
                mesh=(mesh.data, mesh.fsdp, mesh.tensor, mesh.batch_rank))


def sharded_opt_steps(cfg_dict, state_dict, grads):
    """The config's optimizer (built by the trainer over the sharded
    state) stepped once per entry of ``grads`` ([{name: full gradient}]),
    each rank handed its slice; returns the parameters, gathered."""
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.models.gamerft import GameRFT
    from owl_audio_exps_tpu_torch.parallel.sharding import (gather_params,
                                                            mesh_coords_of,
                                                            spec_of)
    from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
    cfg = Config.from_dict(cfg_dict)
    trainer = get_trainer_cls("rft")(cfg, device="cpu")
    model = GameRFT(cfg.model, dtype=torch.float32, device="cpu", seed=None)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_dict.items()}, strict=True)
    state = trainer.make_state(model)
    coords = mesh_coords_of(trainer.mesh)
    for step in grads:
        for name, p in state.model.named_parameters():
            g = torch.from_numpy(step[name])
            spec = spec_of(p)
            p.grad = g if spec is None else spec.shard(g, coords)
        state.optimizer.step()
    return {n: _np(t) for n, t in gather_params(state.model).items()}


def tp_decode(cfg_kw, state_dict, inputs, mesh_kw, n_ticks=3):
    """The TP-sharded cached decode of tests/test_multichip_serve.py on
    this rank: prefill all but the last frame into a ring of this rank's
    heads, decode the last frame; then ``n_ticks`` serve ticks (write,
    decoding) on a fresh ring. Returns the decode's output, the ring
    after the prefill, and the ticks' outputs and counters."""
    from owl_audio_exps_tpu_torch.configs import transformer_config
    from owl_audio_exps_tpu_torch.models.gamerft import GameRFTCore
    from owl_audio_exps_tpu_torch.nn.kv_cache import KVCache
    from owl_audio_exps_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from owl_audio_exps_tpu_torch.parallel.sharding import shard_params
    mesh = make_mesh(MeshConfig(**mesh_kw), device_type="cpu")
    cfg = transformer_config(**cfg_kw)
    core = GameRFTCore(cfg, dtype=torch.float32, device="cpu", seed=None)
    core.load_state_dict({k: torch.from_numpy(v)
                          for k, v in state_dict.items()}, strict=True)
    shard_params(core, mesh)
    x, t, mouse, btn = (torch.from_numpy(a) for a in inputs)
    b, n = x.shape[:2]
    out = {}
    with torch.no_grad():
        cache = KVCache.from_config(cfg, b, capacity_frames=12,
                                    dtype=torch.float32, device="cpu")
        core(x[:, :n - 1], t[:, :n - 1], mouse[:, :n - 1], btn[:, :n - 1],
             kv_cache=cache, write=True)
        out["ring_k"], out["ring_v"] = _np(cache.k), _np(cache.v)
        last = core(x[:, n - 1:], t[:, n - 1:], mouse[:, n - 1:],
                    btn[:, n - 1:], kv_cache=cache, decoding=True)
        out["last"] = _np(last)
        cache = KVCache.from_config(cfg, b, capacity_frames=8,
                                    dtype=torch.float32, device="cpu")
        ticks = []
        for _ in range(n_ticks):
            ticks.append(_np(core(x[:, :1], t[:, :1], mouse[:, :1],
                                  btn[:, :1], kv_cache=cache, write=True,
                                  decoding=True)))
        out["ticks"] = ticks
        out["tick_length"] = int(cache.length)
        out["tick_ring_shape"] = tuple(cache.k.shape)
    out["tensor_index"] = mesh.tensor_index
    return out


def train_and_save(cfg_dict, max_steps):
    """The rft trainer's own loop (bf16 model, seeded weights) for
    ``max_steps`` under the config's mesh, saving at the last step;
    returns the logged losses."""
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
    cfg = Config.from_dict(cfg_dict)
    trainer = get_trainer_cls("rft")(cfg, device="cpu")
    state = trainer.train(max_steps=max_steps)
    return dict(losses=[h["diffusion_loss"] for h in trainer.logger.history],
                step=state.step)


def restore_and_step(cfg_dict, path):
    """Restore ``path`` onto the config's mesh, gather the restored state
    back to full shapes, then take one more step; returns the gathered
    state and the step's loss."""
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
    cfg = Config.from_dict(cfg_dict)
    trainer = get_trainer_cls("rft")(cfg, device="cpu")
    state = trainer.load(path, trainer.init_state())
    full = trainer.logical_state(state)
    restored = dict(
        params={k: _np(v) for k, v in full["params"].items()},
        ema={k: _np(v) for k, v in full["ema_params"].items()},
        moments=_opt_arrays(full["opt_state"]), step=full["step"])
    cfg.train.resume_ckpt = path
    trainer = get_trainer_cls("rft")(cfg, device="cpu")
    state = trainer.train(max_steps=full["step"] + 1)
    return dict(restored=restored, step=state.step,
                losses=[h["diffusion_loss"] for h in trainer.logger.history])


def _opt_arrays(opt_state):
    """{(part, index, key): array} of an optimizer state dict's moments."""
    out = {}
    parts = opt_state if "state" not in opt_state else {None: opt_state}
    for part, sd in parts.items():
        if sd is None:
            continue
        for idx, entry in sd["state"].items():
            for k, v in entry.items():
                if torch.is_tensor(v) and v.ndim:
                    out[(part, idx, k)] = _np(v)
    return out


def collectives(x, g):
    """parallel/dist.py's four differentiable collectives over the
    tensor axis of {fsdp 2, tensor 2}, each on this rank's rows of x
    [4, n] (row = rank) under the cotangent g: (output, input gradient)
    of each."""
    import torch.distributed as dist
    from owl_audio_exps_tpu_torch.parallel import dist as pdist
    from owl_audio_exps_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    mesh = make_mesh(MeshConfig(fsdp=2, tensor=2), device_type="cpu")
    rank, group = dist.get_rank(), mesh.tensor_group
    out = {}
    for name, fn in (
            ("all_gather", lambda t: pdist.all_gather(t, 0, group)),
            ("reduce_scatter", lambda t: pdist.reduce_scatter(t, 0, group)),
            ("all_reduce", lambda t: pdist.all_reduce(t, group)),
            ("copy_to_group", lambda t: pdist.copy_to_group(t, group))):
        t = torch.from_numpy(x[rank]).reshape(2, -1).requires_grad_()
        y = fn(t)
        y.backward(torch.from_numpy(g[rank]).reshape(-1)[:y.numel()]
                   .reshape(y.shape))
        out[name] = (_np(y), _np(t.grad))
    return out


def run_jobs(rank, world, jobs):
    """Run ``jobs`` ([(name, function name, args)]) one after another in
    this world; returns {name: result}."""
    import time
    import torch_sp_workers as me
    out = {}
    for name, fn, args in jobs:
        t0 = time.perf_counter()
        out[name] = getattr(me, fn)(*args)
        out[name + "_s"] = time.perf_counter() - t0
    return out
