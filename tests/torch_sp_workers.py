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


def ring_halo_worker(q, k, v, gw, tpf, window):
    """This rank's slice of sp_attention over full numpy q, k, v [B, H, L,
    Dh]: (out, dq, dk, dv) of its slice under the loss sum(out * gw), and
    the number of ring partials run in the forward and in all."""
    import torch.distributed as dist
    from owl_audio_exps_tpu_torch.parallel import context
    rank, world = dist.get_rank(), dist.get_world_size()
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


def model_worker(cfg_kw, state_dict, inputs, draws):
    """The context-parallel GameRFT on this rank: (its share of the loss,
    its slice of the core's prediction) with the draws handed in."""
    import torch.distributed as dist
    from owl_audio_exps_tpu_torch.configs import transformer_config
    from owl_audio_exps_tpu_torch.models.gamerft import GameRFT
    mesh = _seq_mesh(dist.get_world_size())
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


def trainer_step_worker(cfg_dict, max_steps=1):
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


def _watch(metrics):
    """The step's ``train.watch`` entries as numpy (histogram counts
    int32)."""
    return {k: v.detach().cpu().numpy() for k, v in metrics.items()
            if k.startswith("watch")}


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
                grads=seen, watch=_watch(metrics),
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


# ------------------------------------------------------------ the pipe axis

def _reduce_like_the_trainer(params, mesh):
    """Sum each gradient over the ranks that hold the same elements, as
    trainers/base.py ``reduce_across_ranks`` does (without its division
    by the batch ranks: the callers' losses are global means)."""
    import torch.distributed as dist
    from owl_audio_exps_tpu_torch.parallel.sharding import spec_of
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        spec = spec_of(p)
        group = (mesh.shard_replica_group
                 if spec is not None and "fsdp" in spec.axes
                 else mesh.replica_group)
        if group is not None:
            dist.all_reduce(p.grad, group=group)


def pipe_core(cfg_kw, state_dict, x, t, mesh_kw, grad=True):
    """The pipelined AudioRFTCore (float32) on this rank's rows of x [B,
    n, c], t [B, n] under ``mesh_kw``: its output rows and, under the
    loss mean(out ** 2) over the whole batch, the gradients of the
    parameters it holds (summed as the trainer sums them, gathered to
    full shape), the names it holds and their local shapes."""
    from owl_audio_exps_tpu_torch.configs import transformer_config
    from owl_audio_exps_tpu_torch.models.audiorft import AudioRFTCore
    from owl_audio_exps_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from owl_audio_exps_tpu_torch.parallel.sharding import (gather_params,
                                                            gather_tensor,
                                                            shard_params,
                                                            spec_of,
                                                            stage_of)
    mesh = make_mesh(MeshConfig(**mesh_kw), device_type="cpu")
    cfg = transformer_config(**cfg_kw)
    core = AudioRFTCore(cfg, dtype=torch.float32, device="cpu", seed=None)
    core.load_state_dict({k: torch.from_numpy(v)
                          for k, v in state_dict.items()}, strict=True)
    shard_params(core, mesh)
    per = x.shape[0] // mesh.batch_ranks
    rows = slice(mesh.batch_rank * per, (mesh.batch_rank + 1) * per)
    xr, tr = (torch.from_numpy(np.array(a[rows])) for a in (x, t))
    with torch.set_grad_enabled(grad):
        out = core(xr, tr)
    res = dict(out=_np(out), rows=(rows.start, rows.stop),
               pipe_index=mesh.pipe_index,
               held={n: (tuple(p.shape), stage_of(p))
                     for n, p in core.named_parameters()},
               gathered={n: _np(t) for n, t in gather_params(core).items()})
    if grad:
        ((out.float() ** 2).sum() / out[0].numel() / x.shape[0]).backward()
        params = list(core.parameters())
        _reduce_like_the_trainer(params, mesh)
        res["grads"] = {n: _np(gather_tensor(p.grad, spec_of(p), mesh))
                        for n, p in core.named_parameters()}
    return res


def pipe_refusals(cfg_kw, state_dict, x, t):
    """The pipe axis's refusals on this rank of a {pipe 2} world: a batch
    the micro-batches do not divide, and document packing."""
    from owl_audio_exps_tpu_torch.configs import transformer_config
    from owl_audio_exps_tpu_torch.models.audiorft import AudioRFTCore
    from owl_audio_exps_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from owl_audio_exps_tpu_torch.parallel.sharding import shard_params
    mesh = make_mesh(MeshConfig(pipe=2), device_type="cpu")
    out = {}
    for name, kw, extra in (
            ("batch", dict(pipeline_microbatches=3), {}),
            ("docs", {}, dict(doc_id=torch.zeros(x.shape[:2],
                                                 dtype=torch.int32)))):
        cfg = transformer_config(**dict(cfg_kw, **kw))
        core = AudioRFTCore(cfg, dtype=torch.float32, device="cpu",
                            seed=None)
        core.load_state_dict({k: torch.from_numpy(v)
                              for k, v in state_dict.items()}, strict=True)
        shard_params(core, mesh)
        try:
            with torch.no_grad():
                core(torch.from_numpy(x), torch.from_numpy(t), **extra)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def pipe_cached_sample(cfg_kw, x, mouse, btn):
    """The rft eval's sample (``av_caching``, 2 frames) on a seeded
    pipelined video core whose blocks this rank of a {pipe 2} world holds
    its stage of: the error it raises, None if it samples."""
    from owl_audio_exps_tpu_torch.configs import transformer_config
    from owl_audio_exps_tpu_torch.models.gamerft import GameRFTCore
    from owl_audio_exps_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from owl_audio_exps_tpu_torch.parallel.sharding import shard_params
    from owl_audio_exps_tpu_torch.sampling import get_sampler_cls
    mesh = make_mesh(MeshConfig(pipe=2), device_type="cpu")
    core = GameRFTCore(transformer_config(**cfg_kw), dtype=torch.float32,
                       device="cpu", seed=0)
    shard_params(core, mesh)
    sampler = get_sampler_cls("av_caching")(n_steps=2, num_frames=2,
                                            cfg_scale=1.0)
    try:
        sampler(core, *(torch.from_numpy(a) for a in (x, mouse, btn)),
                generator=torch.Generator().manual_seed(0))
    except ValueError as e:
        return str(e)
    return None


def pipe_train_step(cfg_dict, state_dict, batch, draws, path):
    """One audio RFTTrainer step (model in float32) on this rank's rows of
    the batch under the config's mesh, with the draws handed in; then the
    state saved to ``path`` (rank 0 writes the whole). Returns the loss,
    the gradients the optimizer saw (gathered, the names this rank holds)
    and the logical state after the step."""
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.models.audiorft import AudioRFT
    from owl_audio_exps_tpu_torch.parallel.sharding import (gather_tensor,
                                                            spec_of,
                                                            stage_of)
    from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
    cfg = Config.from_dict(cfg_dict)
    trainer = get_trainer_cls("audio_rft")(cfg, device="cpu")
    mesh = trainer.mesh
    model = AudioRFT(cfg.model, dtype=torch.float32, device="cpu", seed=None)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_dict.items()}, strict=True)
    state = trainer.make_state(model.train())
    per = batch.shape[0] // mesh.batch_ranks
    rows = slice(mesh.batch_rank * per, (mesh.batch_rank + 1) * per)
    mb = [torch.from_numpy(np.array(a[rows])) for a in (batch,) + tuple(draws)]

    def loss_fn(model, mb, generator):
        x, ts, z = mb
        loss = model(x, ts=ts, z=z)
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
    trainer.train_cfg.checkpoint_dir = path
    trainer.save(state)
    full = trainer.logical_state(state)
    return dict(loss=float(metrics["diffusion_loss"]),
                grad_norm=float(metrics.get("grad_norm", float("nan"))),
                param_norm=float(metrics["param_norm"]),
                grads=seen, watch=_watch(metrics),
                pipe_index=mesh.pipe_index,
                stages={n: stage_of(p) for n, p in
                        state.model.named_parameters()},
                logical=None if full is None else dict(
                    params={k: _np(v) for k, v in full["params"].items()},
                    ema={k: _np(v) for k, v in full["ema_params"].items()},
                    moments=_opt_arrays(full["opt_state"]),
                    order=list(full["ema_params"]), step=full["step"]))


def pipe_seeded_state(cfg_dict):
    """The seeded model built under the config's mesh (the blocks left on
    the meta device) and this rank's parameters after the trainer's
    ``init_state`` (the same seed)."""
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.models.audiorft import AudioRFT
    from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
    cfg = Config.from_dict(cfg_dict)
    trainer = get_trainer_cls("audio_rft")(cfg, device="cpu")
    built = AudioRFT(cfg.model, dtype=torch.float32, device="cpu", seed=0)
    blocks = built.core.transformer.blocks
    state = trainer.init_state()
    return dict(meta=[i for i, b in enumerate(blocks)
                      if all(p.is_meta for p in b.parameters())],
                params={n: _np(p) for n, p in
                        state.model.named_parameters()},
                pipe_index=trainer.mesh.pipe_index)


def pipe_restore(cfg_dict, path):
    """Restore ``path`` onto the config's mesh (after every rank has
    passed a barrier: rank 0 wrote it); returns the state gathered back
    to one process's logical state (None but on a pipe group's first
    rank), this rank's own parameters and EMA, and the names it holds."""
    import torch.distributed as dist
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
    dist.barrier()
    cfg = Config.from_dict(cfg_dict)
    trainer = get_trainer_cls("audio_rft")(cfg, device="cpu")
    state = trainer.load(path, trainer.init_state())
    full = trainer.logical_state(state)
    own = dict(params={n: _np(p) for n, p in
                       state.model.named_parameters()},
               ema={n: _np(e) for n, e in state.ema.items()})
    if full is None:
        return dict(own=own, held=sorted(own["params"]))
    return dict(params={k: _np(v) for k, v in full["params"].items()},
                ema={k: _np(v) for k, v in full["ema_params"].items()},
                moments=_opt_arrays(full["opt_state"]), own=own,
                held=sorted(own["params"]))


# --------------------------------------------- context parallelism, AV

def av_sp(model_id, cfg_kw, state_dict, batch, draws, mesh_kw):
    """The context-parallel AV wrapper (``game_rft_audio`` or
    ``game_mft_audio``, float32) on this rank's frames of the whole batch
    (every data rank takes all of it), with the draws handed in: its
    losses (this rank's shares), its frames of the predictions (the RFT
    model's) and every gradient summed over the seq axis."""
    import torch.distributed as dist
    from owl_audio_exps_tpu_torch.configs import transformer_config
    from owl_audio_exps_tpu_torch.models import get_model_cls
    from owl_audio_exps_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    mesh = make_mesh(MeshConfig(**mesh_kw), device_type="cpu")
    cfg = transformer_config(**dict(cfg_kw, sequence_parallel=True))
    model = get_model_cls(model_id)(cfg, dtype=torch.float32, device="cpu",
                                    seed=None)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_dict.items()}, strict=True)
    x, audio, mouse, btn = (torch.from_numpy(a) for a in batch)
    d = {k: torch.from_numpy(v) for k, v in draws.items()}
    out = {}
    if model_id == "game_rft_audio":
        res = model(x, audio, mouse, btn, has_controls=d["has_controls"],
                    ts=d["ts"], z_video=d["z_video"], z_audio=d["z_audio"],
                    return_dict=True)
        losses = [res[k] for k in ("diffusion_loss", "video_loss",
                                   "audio_loss")]
        out.update(pred_video=_np(res["pred_video"]),
                   pred_audio=_np(res["pred_audio"]))
    else:
        losses = model(x, audio, mouse, btn, has_controls=d["has_controls"],
                       ts=d["ts"], rs=d["rs"], z_video=d["z_video"],
                       z_audio=d["z_audio"])
    losses[0].backward()
    grads = {}
    for n, p in model.named_parameters():
        g = p.grad.clone()
        dist.all_reduce(g, group=mesh.seq_group)
        grads[n] = _np(g)
    out.update(losses=[float(v) for v in losses], grads=grads,
               seq_index=mesh.seq_index, data_index=mesh.data_index,
               frames=mesh.seq_frames(x.shape[1]))
    return out


def av_train_step(cfg_dict, state_dict, batch, draws):
    """One AVRFTTrainer.train_step (model in float32) on this rank's rows
    of the batch under the config's mesh, with the draws handed in: the
    logged losses and the gradients the optimizer saw."""
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.models.gamerft_audio import GameRFTAudio
    from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
    cfg = Config.from_dict(cfg_dict)
    trainer = get_trainer_cls("av")(cfg, device="cpu")
    mesh = trainer.mesh
    model = GameRFTAudio(cfg.model, dtype=torch.float32, device="cpu",
                         seed=None)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_dict.items()}, strict=True)
    state = trainer.make_state(model.train())
    per = batch[0].shape[0] // mesh.batch_ranks
    rows = slice(mesh.batch_rank * per, (mesh.batch_rank + 1) * per)
    mb = [torch.from_numpy(np.array(a[rows]))
          for a in tuple(batch) + tuple(draws)]

    def loss_fn(model, mb, generator):
        x, audio, mouse, btn, has, ts, zv, za = mb
        loss, lv, la = model(x, audio, mouse, btn, has_controls=has.bool(),
                             ts=ts, z_video=zv, z_audio=za)
        return loss, {"diffusion_loss": loss.detach(),
                      "video_loss": lv.detach(), "audio_loss": la.detach()}

    trainer.loss_fn = loss_fn
    seen, step = {}, state.optimizer.step

    def spied():
        seen.update({n: _np(p.grad) for n, p in
                     state.model.named_parameters()})
        return step()

    state.optimizer.step = spied
    metrics = trainer.train_step(state, [mb], None,
                                 clip_norm=trainer.grad_clip_norm())
    return dict(losses={k: float(v) for k, v in metrics.items()
                        if k.endswith("loss")},
                grads=seen, mesh=(mesh.data, mesh.seq))


# ------------------------------------------- distillation over processes

def _rows_of(draws, rows):
    """A distillation draw tuple cut to this rank's batch rows (the
    Self-Forcing control permutations must be the identity, which stays
    the identity on the rank's rows)."""
    from owl_audio_exps_tpu_torch.trainers.causvid import (LossDraws,
                                                           RolloutDraws)
    from owl_audio_exps_tpu_torch.trainers.ode_distill import ODEDraws
    from owl_audio_exps_tpu_torch.trainers.self_forcing import SelfForceDraws
    if isinstance(draws, LossDraws):
        return LossDraws(_rows_of(draws.rollout, rows), draws.ts[rows],
                         draws.z[rows])
    if isinstance(draws, RolloutDraws):
        return RolloutDraws(*(a[rows] for a in draws))
    if isinstance(draws, SelfForceDraws):
        d, b = draws.perms.shape
        assert torch.equal(draws.perms, torch.arange(b).expand(d, b))
        n = rows.stop - rows.start
        return SelfForceDraws(torch.arange(n).expand(d, n).contiguous(),
                              draws.init[:, rows], draws.ends)
    if isinstance(draws, ODEDraws):
        return ODEDraws(draws.x[rows], draws.keep)
    raise TypeError(type(draws))


def distill_step(cfg_dict, cores, batch, draws):
    """One outer step of a distillation trainer (float32 cores: student,
    critic, teacher from ``cores``) on this rank's rows of the batch under
    the config's mesh, with the draws handed in ({"critic": ..,
    "student": ..} of the trainer's draw tuples over the whole batch):
    the metrics, the student's and critic's parameters after the step and
    the student's EMA (gathered), and every core's local shapes."""
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.parallel.sharding import (gather_params,
                                                            gather_tensor,
                                                            spec_of)
    from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
    cfg = Config.from_dict(cfg_dict)
    trainer = get_trainer_cls(cfg.train.trainer_id)(cfg, device="cpu",
                                                    dtype=torch.float32)
    state = trainer.init_distill_state()
    mesh = trainer.mesh
    coords = None
    from owl_audio_exps_tpu_torch.parallel.sharding import mesh_coords_of
    coords = mesh_coords_of(mesh)
    with torch.no_grad():
        for key, core in (("student", state.student),
                          ("critic", state.critic),
                          ("teacher", trainer.teacher)):
            for n, p in core.named_parameters():
                full = torch.from_numpy(cores[key][n])
                spec = spec_of(p)
                p.copy_(full if spec is None else spec.shard(full, coords))
        state.student_ema = trainer.ema_of(state.student)
    per = batch[0].shape[0] // mesh.batch_ranks
    rows = slice(mesh.batch_rank * per, (mesh.batch_rank + 1) * per)
    mb = [[torch.from_numpy(np.array(a[rows])) for a in batch]]
    metrics = {}
    if cfg.train.trainer_id == "ode_distill_vid":
        metrics.update(trainer.step(state, mb,
                                    [_rows_of(draws["student"], rows)]))
    else:
        metrics.update(trainer.critic_step(
            state, mb, [_rows_of(draws["critic"], rows)]))
        metrics.update(trainer.student_step(
            state, mb, [_rows_of(draws["student"], rows)]))
    out = dict(metrics={k: float(v) for k, v in metrics.items()},
               mesh=(mesh.data, mesh.fsdp, mesh.tensor, mesh.batch_rank))
    for key, core in (("student", state.student), ("critic", state.critic)):
        out[key] = {n: _np(t) for n, t in gather_params(core, mesh).items()}
    out["ema"] = {n: _np(gather_tensor(e, spec_of(p), mesh))
                  for (n, e), p in zip(state.student_ema.items(),
                                       state.student.parameters())}
    out["local_shapes"] = {
        key: {n: tuple(p.shape) for n, p in core.named_parameters()}
        for key, core in (("student", state.student),
                          ("critic", state.critic),
                          ("teacher", trainer.teacher))}
    out["finite"] = all(torch.isfinite(p).all().item()
                        for core in (state.student, state.critic,
                                     trainer.teacher)
                        for p in core.parameters())
    return out
