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


def _child(fn, rank, world, tmp, args):
    out = os.path.join(tmp, f"rank{rank}.pt")
    try:
        torch.set_num_threads(1)
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
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(fn, r, world, tmp, args))
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
