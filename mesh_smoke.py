"""Sharded training and serving of the port across four cards (or CPU
processes): configs/dit_v4_5B.yml through the port's trainer at its
written mesh {fsdp 4} and at {fsdp 2, tensor 2}, and its cached serve
with the KV ring sharded over heads at {tensor 4}.

Usage (from the repository root, one process per card):

    torchrun --nproc_per_node 4 mesh_smoke.py [--config_path configs/dit_v4_5B.yml] [--max_steps 2] [--serve_ticks 8] [--parity_only]
    torchrun --nproc_per_node 3 mesh_smoke.py --case pipe [--config_path configs/dit_v4_5B.yml] [--parity_only]
    torchrun --nproc_per_node 4 mesh_smoke.py --case distill [--parity_only]

and on the CPU (gloo), with a small config:

    torchrun --nproc_per_node 4 mesh_smoke.py --config_path <cfg> --device cpu

``--case pipe`` trains the config with ``pipeline_parallel`` over {pipe
K} (K the processes: 3 for the 5B, whose 9 groups four stages cannot
divide), ``pipeline_microbatches`` 3 and batch 3, from a seeded table
read by the ``cod`` windowed loader at the config's window (the pipe
axis refuses documents), accumulation cut to 1 (all printed); each rank
reports its seconds a step, peak memory, exact K1 and band launches, and
from one traced step its P2P device ms and the bubble (the share of the
step its card computes nothing). A 12-layer full-width copy at
``PIPE_CHECK_FRAMES`` frames takes the same steps and is held against one
card by chip_smoke.py ``parity_verdict`` (the losses, every parameter's
first gradient, the whole model's update). After the steps the first
stage collects the whole checkpoint, as ``save`` does, and serializes it
into a byte counter (timed, with the cards' and the host's peaks).
``--case distill`` trains configs/dit_v4_dmd.yml (CausVid) at
{data 4} (the reference's DDP) and {fsdp 2, tensor 2}, dit_v4_sf.yml and
dit_v4_prune.yml at {data 4}, seeded cores, two outer steps each: the
student's and the critic's seconds, peak memory and K1 launches a rank;
the {fsdp 2, tensor 2} CausVid run is held against one card taking both
batch ranks' micro-batches with their generators (``parity_verdict``
over the student and the critic's first gradients). ``--parity_only``
runs the held copies alone.

Every process builds the trainer as ``python -m
owl_audio_exps_tpu_torch.train`` does (the same cuts, printed, and these:
the data is a seeded packed table written under build/mesh_smoke/ at the
config's window, read by its ``sequence_packing`` loader; accumulation
is cut to one micro-batch a batch rank; the mesh is the case's). Each
mesh takes ``--max_steps`` steps; each rank reports its seconds a step,
its peak device memory and its exact K1 launches (every layer takes K1:
the packed batch carries documents), and traces one more micro-batch
(device time by kernel class, NCCL's all-gather, reduce-scatter and
all-reduce apart). Then a 2-layer copy at full width takes the same
steps on each mesh and its parameters are gathered (these copies, the
pipe case's too, run ``train.watch: full``, whose dict is held against
one card's by chip_smoke.py ``watch_verdict``; ``--parity_only`` runs
only the copies). The serve primes a
ring of ``SERVE_WINDOW`` frames through ``CachedStreamingPipeline`` (the
config's sampler's 16 steps) and runs ``--serve_ticks`` steady ticks at
{tensor 4}: ms a tick, graph or eager (as the pipeline decides from the
mesh), the ring's heads a rank. After the process group is left, rank 0
alone runs the references on its card: the 2-layer copy's steps unsharded
(the batch ranks' micro-batches accumulated, each with its rank's
generator), held to the port's limits (loss 1e-2 relative, parameters
3e-2 relative L2), and the same ticks from the whole bf16 model (5e-2
relative L2). Rank 0 prints one JSON line last; every process exits
non-zero on any failure.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import shutil
import statistics
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

import chip_smoke

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "mesh_smoke")
TRAIN_MESHES = ({"fsdp": 4}, {"fsdp": 2, "tensor": 2})
SERVE_MESH = {"tensor": 4}
CHECK_LAYERS = 2
LOSS_REL, PARAM_REL, SERVE_REL = 1e-2, 3e-2, 5e-2
SERVE_WINDOW, SERVE_PRIME = 32, 8


def say(msg: str):
    print(f"[mesh] {msg}", flush=True)


def mesh_name(mesh) -> str:
    return " x ".join(f"{k} {v}" for k, v in mesh.items())


def train_config(args, mesh, table, n_layers=None, tag="mesh"):
    """The config with the entry point's cuts and the run's, printed by
    rank 0; ``n_layers`` cuts the depth (the parity copy)."""
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.train import port_cuts
    cfg = Config.from_yaml(args.config_path)
    tc = cfg.train
    world = int(os.environ.get("WORLD_SIZE", 1))
    cuts = chip_smoke.Cuts()
    cut = cuts.cut
    batch_ranks = world // (mesh.get("tensor", 1) * mesh.get("seq", 1))
    kw = dict(tc.data_kwargs.items())
    kw["dataset_path"] = table
    cut(tc, "data_kwargs", kw, "the run's seeded packed table")
    cut(tc, "mesh", dict(mesh), "the case")
    cut(tc, "target_batch_size", tc.batch_size * batch_ranks,
        f"accumulation {max(1, tc.target_batch_size // tc.batch_size // batch_ranks)}"
        " -> 1 a batch rank")
    cuts.no_checkpoint(tc, WORK)
    if n_layers is not None:
        cut(cfg.model, "n_layers", n_layers,
            "the parity copy, which one card takes unsharded")
        cut(tc, "watch", "full", "the parity copy's telemetry, held "
            "against one card")
    cuts += port_cuts(cfg, world)
    cuts.show(f"[{tag}] cut")
    return cfg


def write_table(args, world_rank):
    """Rank 0 writes the seeded packed table at the config's shapes
    (documents of an eighth to four thirds of the window); every rank
    waits for it."""
    from owl_audio_exps_tpu_torch.configs import Config
    cfg = Config.from_yaml(args.config_path)
    W = cfg.train.data_kwargs["window_length"]
    table = os.path.join(WORK, "table")
    if world_rank == 0:
        shutil.rmtree(WORK, ignore_errors=True)
        os.makedirs(WORK, exist_ok=True)
        t0 = time.perf_counter()
        lens = chip_smoke.write_packed_table(table, cfg.model,
                                             doc_frames=(max(2, W // 8),
                                                         W * 4 // 3))
        say(f"wrote a packed table of {len(lens)} documents, "
            f"{sum(lens)} frames, in {time.perf_counter() - t0:.1f} s")
    if dist.is_initialized():
        dist.barrier()
    return table


def expected_k1(cfg, accum: int, on_card: bool):
    """K1 launches per step on every rank: each layer's attention forwards
    under the config's remat, and one dq and one dkv a layer."""
    from owl_audio_exps_tpu_torch.nn.attn import attention_forwards_per_step
    n = cfg.n_layers
    per = {"frame_attention_fwd": sum(attention_forwards_per_step(cfg)),
           "frame_attention_bwd_dq": n, "frame_attention_bwd_dkv": n}
    return {k: per.get(k, 0) * accum * on_card
            for k in chip_smoke.kernel_counts()}


def trace_micro(trainer, state, micro, gen):
    """Device ms by kernel class of one traced micro-batch step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from owl_audio_exps_tpu_torch.trainers.base import BaseTrainer
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        BaseTrainer.train_step(trainer, state, [micro], gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    classes = dict.fromkeys(("K1 fwd", "K1 bwd", "nccl all-gather",
                             "nccl reduce-scatter", "nccl all-reduce",
                             "nccl other", "matmul", "other"), 0.0)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False):
            continue
        n, us = e.name.lower(), e.time_range.elapsed_us()
        if "frame_attn_fwd" in n:
            classes["K1 fwd"] += us
        elif "frame_attn_bwd" in n:
            classes["K1 bwd"] += us
        elif "nccl" in n:
            kind = ("all-gather" if "allgather" in n else
                    "reduce-scatter" if "reducescatter" in n else
                    "all-reduce" if "allreduce" in n else "other")
            classes[f"nccl {kind}"] += us
        elif any(t in n for t in ("gemm", "nvjet", "cutlass", "sm90_xmma")):
            classes["matmul"] += us
        else:
            classes["other"] += us
    return dict(wall_ms=1e3 * wall,
                device_ms={k: v / 1e3 for k, v in classes.items()},
                busy_ms=sum(classes.values()) / 1e3)


def train_case(args, mesh, table, device, on_card):
    """``--max_steps`` steps of the config at ``mesh``, counted, with one
    traced micro-batch on the card; this rank's report."""
    from owl_audio_exps_tpu_torch.data import get_loader
    from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
    cfg = train_config(args, mesh, table)
    tc = cfg.train
    base = get_trainer_cls(tc.trainer_id)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    trainer = chip_smoke.counted_trainer(base)(cfg, device=device)
    m = trainer.mesh
    accum = trainer.accum_steps()
    t0 = time.perf_counter()
    state = trainer.train(max_steps=args.max_steps)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 \
        if on_card else None
    expect = expected_k1(cfg.model, accum, on_card)
    failures = []
    for i, st in enumerate(trainer.steps):
        if not math.isfinite(st["loss"]):
            failures.append(f"{mesh_name(mesh)} step {i + 1}: loss not "
                            "finite")
        if st["counts"] != expect:
            failures.append(f"{mesh_name(mesh)} step {i + 1}: launches "
                            f"{st['counts']}, expected {expect}")
    heads = state.model.core.transformer.blocks[0].attn.qkv.weight.shape[0] \
        // (3 * (cfg.model.d_model // cfg.model.n_heads))
    trace = None
    if on_card:
        loader = iter(get_loader(tc.data_id, tc.batch_size,
                                 **dict(tc.data_kwargs.items())))
        micro = trainer.to_device(next(loader))
        gen = torch.Generator(device=device).manual_seed(99)
        trace = trace_micro(trainer, state, micro, gen)
    local = sum(p.numel() for p in state.model.parameters())
    report = dict(mesh=dict(mesh), batch_rank=m.batch_rank,
                  tensor_index=m.tensor_index, heads=heads,
                  local_params=local, steps_s=[st["s"] for st in
                                               trainer.steps],
                  losses=[st["loss"] for st in trainer.steps],
                  launches_per_step=trainer.steps[-1]["counts"],
                  expected_launches=expect, peak_gib=peak, wall_s=wall,
                  trace=trace, failures=failures,
                  tokens_per_step=tc.data_kwargs["window_length"]
                  * cfg.model.tokens_per_frame * tc.batch_size * accum
                  * m.batch_ranks)
    del state, trainer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return report


def parity_run(args, mesh, table, device):
    """The 2-layer copy's steps at ``mesh``; its parameters gathered
    (every rank takes part), kept on rank 0's host."""
    from owl_audio_exps_tpu_torch.parallel.sharding import gather_params
    from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
    cfg = train_config(args, mesh, table, n_layers=CHECK_LAYERS,
                       tag="parity")
    trainer = chip_smoke.counted_trainer(
        get_trainer_cls(cfg.train.trainer_id))(cfg, device=device)
    batch_ranks = trainer.mesh.batch_ranks
    state = trainer.train(max_steps=args.max_steps)
    params = {k: v.cpu() for k, v in gather_params(state.model).items()}
    losses = [h["diffusion_loss"] for h in trainer.logger.history]
    watch = [st["metrics"] for st in trainer.steps]
    del state, trainer
    gc.collect()
    return dict(params=params, losses=losses, batch_ranks=batch_ranks,
                mesh=dict(mesh), watch=watch)


def parity_reference(args, run, table, device):
    """Rank 0 alone: the same steps of the 2-layer copy unsharded, the
    batch ranks' micro-batches accumulated, each drawn with its rank's
    generator (seeded 1234 + batch rank, as the trainer seeds it)."""
    from owl_audio_exps_tpu_torch.data import get_loader
    from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
    B = run["batch_ranks"]
    cfg = train_config(args, {}, table, n_layers=CHECK_LAYERS, tag="parity")
    tc = cfg.train
    tc.target_batch_size = tc.batch_size * B
    base = get_trainer_cls(tc.trainer_id)

    class PerRankDraws(base):
        def loss_fn(self, model, batch, generator):
            gen = self.gens[self.mb % B]
            self.mb += 1
            return super().loss_fn(model, batch, gen)

    trainer = PerRankDraws(cfg, device=device)
    trainer.mb = 0
    trainer.gens = [torch.Generator(device=device).manual_seed(1234 + b)
                    for b in range(B)]
    loaders = [iter(get_loader(tc.data_id, tc.batch_size,
                               **dict(tc.data_kwargs.items()),
                               process_index=b, process_count=B))
               for b in range(B)]
    state = trainer.init_state()
    init = {k: v.detach().cpu().clone()
            for k, v in state.model.named_parameters()}
    losses, watch = [], []
    for _ in range(args.max_steps):
        micro = [trainer.to_device(next(it)) for it in loaders]
        metrics = trainer.train_step(state, micro, None,
                                     clip_norm=trainer.grad_clip_norm())
        losses.append(float(metrics["diffusion_loss"]))
        watch.append({k: chip_smoke.metric_value(v)
                      for k, v in metrics.items()})
    ref = {k: v.detach().cpu() for k, v in state.model.named_parameters()}
    got = run["params"]

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    p_rel = max(rel(got[k], ref[k]) for k in ref)
    upd_rel = max(rel(got[k] - init[k], ref[k] - init[k]) for k in ref
                  if (ref[k] - init[k]).norm() > 0)
    l_rel = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], losses))
    n_params = sum(v.numel() for v in ref.values())
    del state, trainer
    gc.collect()
    return dict(loss_rel=l_rel, param_rel_l2=p_rel, update_rel_l2=upd_rel,
                losses=run["losses"], ref_losses=losses,
                **chip_smoke.watch_verdict(run["watch"], watch, n_params))


def serve_core(cfg, device):
    from owl_audio_exps_tpu_torch.models.gamerft import GameRFTCore
    return GameRFTCore(cfg, dtype=torch.bfloat16, device=device,
                       seed=0).to(torch.bfloat16).eval()


def serve_run(args, conf, device, on_card, sharded: bool):
    """Prime the ring, then ``--serve_ticks`` steady ticks (one first
    tick before them) of the config ``conf``'s model with its sampler's
    steps; the tick outputs, their ms and the ring's heads."""
    from owl_audio_exps_tpu_torch.inference.pipeline import \
        CachedStreamingPipeline
    from owl_audio_exps_tpu_torch.parallel.mesh import get_mesh
    from owl_audio_exps_tpu_torch.parallel.sharding import shard_params
    cfg, skw = conf.model, conf.train.sampler_kwargs
    core = serve_core(cfg, device)
    if sharded:
        shard_params(core, get_mesh())
    steps = int(skw.get("n_steps", 16))
    pipe = CachedStreamingPipeline(
        core, cfg, window_frames=SERVE_WINDOW, sampling_steps=steps,
        noise_prev=float(skw.get("noise_prev", 0.2)), seed=0, device=device)
    gen = torch.Generator(device=device).manual_seed(5)
    p = cfg.sample_size
    ctx = (torch.randn(1, SERVE_PRIME, cfg.channels, p, p, generator=gen,
                       device=device),
           torch.randn(1, SERVE_PRIME, 2, generator=gen, device=device),
           (torch.rand(1, SERVE_PRIME, cfg.n_buttons, generator=gen,
                       device=device) > 0.5).float())
    pipe.prime(*ctx)
    rs = np.random.RandomState(6)
    outs, ms = [], []
    for i in range(args.serve_ticks + 1):
        frame, _, secs = pipe(rs.randn(2).astype(np.float32),
                              (rs.rand(cfg.n_buttons) > 0.5).astype(
                                  np.float32))
        outs.append(frame.float().cpu())
        if i:
            ms.append(1e3 * secs)
    trace = None
    if on_card:
        # one more steady tick traced: device busy, NCCL and kernels
        per_name, wall = chip_smoke.trace_call(lambda: pipe(
            rs.randn(2).astype(np.float32),
            (rs.rand(cfg.n_buttons) > 0.5).astype(np.float32)))
        busy = sum(us for us, _ in per_name.values()) / 1e3
        nccl = sum(us for n, (us, _) in per_name.items()
                   if "nccl" in n.lower()) / 1e3
        trace = dict(wall_ms=wall, busy_ms=busy, nccl_ms=nccl,
                     kernels=sum(c for _, c in per_name.values()))
    heads = pipe.cache.k.shape[2]
    graphed = bool(pipe.graphed)
    del pipe, core
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return dict(outs=outs, tick_ms=ms, ring_heads=heads, graphed=graphed,
                steps=steps, trace=trace)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_path",
                        default=os.path.join("configs", "dit_v4_5B.yml"))
    parser.add_argument("--max_steps", type=int, default=2)
    parser.add_argument("--serve_ticks", type=int, default=8)
    parser.add_argument("--device", default="cuda", help="cuda or cpu")
    parser.add_argument("--case", default="fsdp",
                        choices=("fsdp", "pipe", "distill"))
    parser.add_argument("--parity_only", action="store_true",
                        help="only the copies held against one card")
    parser.add_argument("--distill_configs", default=None,
                        help="comma-separated paths for --case distill "
                        "(by default configs/dit_v4_{dmd,sf,prune}.yml)")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    if args.case != "fsdp":
        return case_main(args)
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.parallel import dist as pdist
    from owl_audio_exps_tpu_torch.parallel import mesh as pmesh

    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("FAILED: no CUDA device", flush=True)
        sys.exit(2)
    if on_card:
        from owl_audio_exps_tpu_torch.ops import _build
        t0 = time.perf_counter()
        _build.build_all()
        build_s = time.perf_counter() - t0
    local_rank = pdist.init_distributed(args.device)
    world, rank = pdist.process_count(), pdist.process_index()
    device = torch.device(f"cuda:{local_rank}" if on_card else "cpu")
    if world != 4:
        print(f"FAILED: {world} processes; the meshes need 4", flush=True)
        sys.exit(2)
    main_rank = rank == 0
    if main_rank:
        say(f"{world} processes on {args.device}")
        if on_card:
            import subprocess
            cards = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True).stdout.strip().replace("\n", " | ")
            say(f"kernels built in {build_s:.1f} s; cards: {cards}")
    table = write_table(args, rank)

    reports = {}
    for mesh in () if args.parity_only else TRAIN_MESHES:
        t0 = time.perf_counter()
        rep = reports[mesh_name(mesh)] = train_case(args, mesh, table,
                                                    device, on_card)
        # each rank's line at once, so that a later failure keeps it
        print(f"[mesh] {mesh_name(mesh)} rank {rank}: steps "
              + " ".join(f"{x:.3f}" for x in rep["steps_s"]) + " s, peak "
              + (f"{rep['peak_gib']:.2f} GiB" if on_card else "n/a")
              + f", {rep['heads']} heads, launches {rep['launches_per_step']}"
              + (f", traced micro-batch {rep['trace']}" if rep["trace"]
                 else "") + f", failures {rep['failures']}", flush=True)
        if main_rank:
            say(f"{mesh_name(mesh)}: {args.max_steps} steps and a traced "
                f"micro-batch in {time.perf_counter() - t0:.1f} s")
    runs = [parity_run(args, mesh, table, device) for mesh in TRAIN_MESHES]

    cfg = Config.from_yaml(args.config_path)
    if not args.parity_only:
        pmesh.make_mesh(pmesh.MeshConfig(**SERVE_MESH),
                        device_type=device.type)
        served = serve_run(args, cfg, device, on_card, sharded=True)

    gathered = [None] * world
    dist.all_gather_object(gathered, reports)
    pdist.cleanup()
    pmesh.make_mesh()        # one process from here on
    bad = [f for rep in gathered for r in rep.values()
           for f in r["failures"]]
    if not main_rank:
        sys.exit(1 if bad else 0)

    # ------------------------------------------- rank 0 alone: references
    for name in reports:
        for r, rep in enumerate(gathered):
            x = rep[name]
            t = x["trace"]
            say(f"{name} rank {r} (batch rank {x['batch_rank']}, tensor "
                f"{x['tensor_index']}, {x['heads']} heads, "
                f"{x['local_params']:,} parameters): steps "
                + " ".join(f"{s:.3f}" for s in x["steps_s"]) + " s, losses "
                + " ".join(f"{v:.5f}" for v in x["losses"])
                + (f", peak {x['peak_gib']:.2f} GiB" if on_card else "")
                + f", launches per step {x['launches_per_step']}")
            if t:
                say(f"  traced micro-batch: wall {t['wall_ms']:.1f} ms, "
                    f"device busy {t['busy_ms']:.1f} ms: " + ", ".join(
                        f"{k} {v:.1f}" for k, v in t["device_ms"].items()))
    parity = {}
    for run in runs:
        name = mesh_name(run["mesh"])
        res = parity_reference(args, run, table, device)
        parity[name] = res
        say(f"parity {name}: {CHECK_LAYERS}-layer copy, {args.max_steps} "
            f"steps: losses {res['losses']} vs one card {res['ref_losses']}"
            f" (worst rel {res['loss_rel']:.3e}, limit {LOSS_REL}); "
            f"parameters rel L2 {res['param_rel_l2']:.3e} (limit "
            f"{PARAM_REL}); their updates rel L2 {res['update_rel_l2']:.3e};"
            f" watch full: {res['watch_keys']} keys, worst norm rel "
            f"{res['watch_norm_rel']:.3e} ({res['watch_worst']}), histogram "
            f"totals exact unless listed: {res['failures']}")
        if res["loss_rel"] > LOSS_REL or res["param_rel_l2"] > PARAM_REL:
            bad.append(f"parity {name}: the sharded steps disagree with one "
                       "card")
        bad += [f"parity {name}: {f}" for f in res["failures"]]
    if args.parity_only:
        shutil.rmtree(WORK, ignore_errors=True)
        for f in bad:
            print(f"FAILED: {f}", flush=True)
        print(json.dumps(dict(ok=not bad, world=world, parity=parity)),
              flush=True)
        sys.exit(1 if bad else 0)
    ref = serve_run(args, cfg, device, on_card, sharded=False)
    serve_rel = max(chip_smoke.rel_l2(a, b)
                    for a, b in zip(served["outs"], ref["outs"]))
    serve = dict(tick_ms=statistics.median(served["tick_ms"]),
                 ticks_ms=served["tick_ms"], graphed=served["graphed"],
                 ring_heads_per_rank=served["ring_heads"],
                 one_card_tick_ms=statistics.median(ref["tick_ms"]),
                 one_card_graphed=ref["graphed"], steps=served["steps"],
                 rel_l2_vs_one_card=serve_rel, ticks=args.serve_ticks,
                 traced_tick=served["trace"],
                 one_card_traced_tick=ref["trace"])
    say(f"serve {mesh_name(SERVE_MESH)}: {args.serve_ticks} steady ticks of "
        f"{served['steps']} steps, median {serve['tick_ms']:.2f} ms a tick "
        f"({'graphed' if served['graphed'] else 'eager'}), ring heads a "
        f"rank {served['ring_heads']}; one card "
        f"{serve['one_card_tick_ms']:.2f} ms "
        f"({'graphed' if ref['graphed'] else 'eager'}); worst tick rel L2 "
        f"{serve_rel:.3e} (limit {SERVE_REL}); a traced tick at tensor 4 "
        f"{served['trace']}, on one card {ref['trace']}")
    if serve_rel > SERVE_REL or not all(
            torch.isfinite(o).all() for o in served["outs"]):
        bad.append("serve: the head-sharded ticks disagree with one card")
    shutil.rmtree(WORK, ignore_errors=True)

    summary = {}
    for name in reports:
        times = [statistics.median(rep[name]["steps_s"][1:]
                                   or rep[name]["steps_s"])
                 for rep in gathered]
        step_s = max(times)
        summary[name] = dict(
            step_s=step_s,
            tokens_per_s=gathered[0][name]["tokens_per_step"] / step_s,
            peak_gib=[rep[name]["peak_gib"] for rep in gathered],
            launches_per_step=[rep[name]["launches_per_step"]
                               for rep in gathered],
            nccl_ms=[{k: v for k, v in rep[name]["trace"]["device_ms"]
                      .items() if k.startswith("nccl")}
                     if rep[name]["trace"] else None for rep in gathered],
            reports=[rep[name] for rep in gathered])
        say(f"{name}: step {step_s:.3f} s (slowest rank's median), "
            f"{summary[name]['tokens_per_s']:.0f} tokens/s")
    for f in bad:
        print(f"FAILED: {f}", flush=True)
    print(json.dumps(dict(ok=not bad, world=world, train=summary,
                          parity=parity, serve=serve)), flush=True)
    sys.exit(1 if bad else 0)


# ------------------------------------------------------------- --case pipe

PIPE_MICRO = 3          # pipeline_microbatches and the batch a data rank
PIPE_CHECK_LAYERS, PIPE_CHECK_FRAMES = 12, 256
PIPE_DOCS = 6


def pipe_config(args, table, world, n_layers=None, frames=None,
                tag="pipe"):
    """The config for the pipe case, every cut printed by rank 0."""
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.train import port_cuts
    cfg = Config.from_yaml(args.config_path)
    m, tc = cfg.model, cfg.train
    cuts = chip_smoke.Cuts()
    cut = cuts.cut
    cut(m, "pipeline_parallel", True, "the pipe case")
    cut(m, "pipeline_microbatches", PIPE_MICRO, "the pipe case")
    W = frames or tc.data_kwargs["window_length"]
    cut(tc, "data_id", "cod", "the pipe axis refuses documents in both "
        "packages: the windowed loader")
    cut(tc, "data_kwargs", dict(window_length=W, dataset_path=table,
                                batch_columns=["video", "mouse", "buttons"]),
        "the run's seeded table")
    cut(tc, "batch_size", PIPE_MICRO, "one sample a micro-batch")
    cut(tc, "target_batch_size", PIPE_MICRO, "accumulation 1")
    cut(tc, "mesh", {"data": 1, "pipe": world},
        f"{world} stages of whole groups")
    cuts.no_checkpoint(tc, WORK)
    if n_layers is not None:
        cut(m, "n_layers", n_layers, "the parity copy")
        cut(tc, "watch", "full", "the parity copy's telemetry, held "
            "against one card")
    if frames is not None:
        cut(m, "n_frames", frames, "the parity copy's window")
    cuts += port_cuts(cfg, world)
    cuts.show(f"[{tag}] cut")
    return cfg


def check_frames(args) -> int:
    """The parity copy's window: PIPE_CHECK_FRAMES, or the config's when
    shorter."""
    from owl_audio_exps_tpu_torch.configs import Config
    W = Config.from_yaml(args.config_path).train.data_kwargs["window_length"]
    return min(PIPE_CHECK_FRAMES, W)


def write_window_table(args, world_rank):
    """Rank 0 writes a seeded table of ``PIPE_DOCS`` documents, each at
    least one window long; every rank waits for it."""
    from owl_audio_exps_tpu_torch.configs import Config
    cfg = Config.from_yaml(args.config_path)
    W = cfg.train.data_kwargs["window_length"]
    table = os.path.join(WORK, "table")
    if world_rank == 0:
        shutil.rmtree(WORK, ignore_errors=True)
        os.makedirs(WORK, exist_ok=True)
        lens = chip_smoke.write_packed_table(table, cfg.model,
                                             docs=PIPE_DOCS,
                                             doc_frames=(W, W + W // 4))
        say(f"wrote a table of {len(lens)} documents, {sum(lens)} frames")
    if dist.is_initialized():
        dist.barrier()
    return table


def pipe_expected(cfg, mesh, on_card):
    """K1 and band launches a step on this rank: its stage's blocks, each
    checkpointed (2 attention forwards a micro-batch), one backward each;
    global layers take K1, local ones the band (K2 at the 5B's tpf 64)."""
    from owl_audio_exps_tpu_torch.nn.attn import (attention_route,
                                                  local_layer_flags)
    from owl_audio_exps_tpu_torch.parallel.pipeline import stage_blocks
    flags = local_layer_flags(cfg)
    blocks = stage_blocks(cfg, mesh.pipe, mesh.pipe_index)
    L = cfg.n_frames * cfg.tokens_per_frame
    M = cfg.pipeline_microbatches
    counts = dict.fromkeys(chip_smoke.kernel_counts(), 0)
    for i in blocks:
        name = ("frame_attention" if not flags[i] else
                attention_route(cfg, True, L)[0] + "_attention")
        if name == "splash_attention":
            name = "frame_attention"
        counts[f"{name}_fwd"] += 2 * M
        if name == "frame_attention":
            counts["frame_attention_bwd_dq"] += M
            counts["frame_attention_bwd_dkv"] += M
        else:
            counts[f"{name}_bwd"] += M
    return {k: v * on_card for k, v in counts.items()}


def trace_pipe_step(trainer, state, micro, gen):
    """Device ms by kernel class of one traced step, the P2P transfers
    apart, and the bubble: the share of the step's wall time in which the
    card ran no kernel but NCCL's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from owl_audio_exps_tpu_torch.trainers.base import BaseTrainer
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        BaseTrainer.train_step(trainer, state, [micro], gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    classes = dict.fromkeys(("K1", "band", "nccl p2p", "nccl broadcast",
                             "nccl all-reduce", "nccl other", "matmul",
                             "other"), 0.0)
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False):
            continue
        n, us = e.name.lower(), e.time_range.elapsed_us()
        if "nccl" in n:
            kind = ("p2p" if "sendrecv" in n or "send" in n or "recv" in n
                    else "broadcast" if "broadcast" in n else
                    "all-reduce" if "allreduce" in n else "other")
            classes[f"nccl {kind}"] += us
            continue
        spans.append((e.time_range.start, e.time_range.end))
        if "frame_attn" in n:
            classes["K1"] += us
        elif "band_attn" in n:
            classes["band"] += us
        elif any(t in n for t in ("gemm", "nvjet", "cutlass", "sm90_xmma")):
            classes["matmul"] += us
        else:
            classes["other"] += us
    # the union of the compute kernels' spans
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    wall_ms = 1e3 * wall
    return dict(wall_ms=wall_ms, compute_ms=busy / 1e3,
                bubble_share=max(0.0, 1.0 - busy / 1e3 / wall_ms),
                device_ms={k: v / 1e3 for k, v in classes.items()})


class ByteCounter:
    """A writable sink that keeps only the count of the bytes written."""

    def __init__(self):
        self.n = 0

    def write(self, b):
        self.n += len(b)
        return len(b)

    def flush(self):
        pass


def pipe_checkpoint(trainer, state, device):
    """The checkpoint of ``state`` as ``BaseTrainer.save`` makes it: the
    whole logical state collected on the pipe group's first rank
    (``logical_state``: each stage's tensors sent there one at a time),
    then serialized with torch.save into a byte counter (the machine
    caps a call's disk writes below a 5B checkpoint). Every rank takes
    part; seconds, bytes, the card's and the host's peaks."""
    import resource
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    dist.barrier()
    t0 = time.perf_counter()
    payload = trainer.logical_state(state)
    out = dict(collect_s=time.perf_counter() - t0, peak_gib=(
        torch.cuda.max_memory_allocated(device) / 2 ** 30 if on_card
        else None))
    if payload is not None:
        sink = ByteCounter()
        t0 = time.perf_counter()
        torch.save(payload, sink)
        out.update(serialize_s=time.perf_counter() - t0,
                   gib=sink.n / 2 ** 30,
                   tensors=sum(len(v) for k, v in payload.items()
                               if k in ("params", "ema_params")))
        del payload
    out["host_peak_gib"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    dist.barrier()
    return out


def pipe_train(args, table, world, device, on_card, n_layers=None,
               frames=None, tag="pipe", save=False):
    """The pipe case's steps (counted) on this rank; with ``n_layers`` the
    parity copy, whose parameters are gathered from every stage."""
    from owl_audio_exps_tpu_torch.data import get_loader
    from owl_audio_exps_tpu_torch.parallel.sharding import gather_params
    from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
    cfg = pipe_config(args, table, world, n_layers, frames, tag)
    tc = cfg.train
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    cls = chip_smoke.counted_trainer(get_trainer_cls(tc.trainer_id))
    if n_layers is not None:
        cls = chip_smoke.recording_grads(cls)
    trainer = cls(cfg, device=device)
    m = trainer.mesh
    t0 = time.perf_counter()
    state = trainer.train(max_steps=args.max_steps)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 \
        if on_card else None
    expect = pipe_expected(cfg.model, m, on_card)
    failures = []
    for i, st in enumerate(trainer.steps):
        if not math.isfinite(st["loss"]):
            failures.append(f"{tag} rank {m.pipe_index} step {i + 1}: loss "
                            "not finite")
        if st["counts"] != expect:
            failures.append(f"{tag} rank {m.pipe_index} step {i + 1}: "
                            f"launches {st['counts']}, expected {expect}")
    blocks = sorted(int(n.split(".")[3]) for n, _ in
                    state.model.named_parameters()
                    if n.startswith("core.transformer.blocks.")
                    and n.endswith("attn.qkv.weight"))
    out = dict(stage=m.pipe_index, blocks=[blocks[0], blocks[-1]],
               steps_s=[st["s"] for st in trainer.steps],
               losses=[st["loss"] for st in trainer.steps],
               launches_per_step=trainer.steps[-1]["counts"],
               expected_launches=expect, peak_gib=peak, wall_s=wall,
               failures=failures,
               local_params=sum(p.numel() for p in
                                state.model.parameters()))
    if n_layers is None and on_card:
        loader = iter(get_loader(tc.data_id, tc.batch_size,
                                 **dict(tc.data_kwargs.items())))
        micro = trainer.to_device(next(loader))
        gen = torch.Generator(device=device).manual_seed(99)
        out["trace"] = trace_pipe_step(trainer, state, micro, gen)
    if n_layers is None and save:
        out["checkpoint"] = pipe_checkpoint(trainer, state, device)
    if n_layers is not None:
        out["params"] = {k: v.cpu() for k, v in
                         gather_params(state.model, m).items()}
        out["grads"] = chip_smoke.first_grads(trainer, state.model)
        out["losses"] = [h["diffusion_loss"] for h in
                         trainer.logger.history] or out["losses"]
        out["watch"] = [st["metrics"] for st in trainer.steps]
    del state, trainer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return out


def pipe_reference(args, table, world, device, run):
    """Rank 0 alone: the parity copy's steps on its card, unpipelined."""
    from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
    cfg = pipe_config(args, table, 1, PIPE_CHECK_LAYERS, check_frames(args),
                      tag="parity")
    trainer = chip_smoke.recording_grads(chip_smoke.counted_trainer(
        get_trainer_cls(cfg.train.trainer_id)))(cfg, device=device)
    init = {k: v.detach().cpu().clone()
            for k, v in trainer.init_state().model.named_parameters()}
    state = trainer.train(max_steps=args.max_steps)
    ref = {k: v.detach().cpu() for k, v in state.model.named_parameters()}
    losses = [h["diffusion_loss"] for h in trainer.logger.history]
    verdict = chip_smoke.parity_verdict(
        max(abs(a - b) / abs(b) for a, b in zip(run["losses"], losses)),
        run["params"], ref, init, run["grads"],
        chip_smoke.first_grads(trainer, state.model))
    watch = chip_smoke.watch_verdict(
        run["watch"], [st["metrics"] for st in trainer.steps],
        sum(v.numel() for v in ref.values()))
    verdict["failures"] += watch.pop("failures")
    return dict(**verdict, **watch, losses=run["losses"], ref_losses=losses)


# ---------------------------------------------------------- --case distill

DISTILL_CONFIGS = (("dit_v4_dmd.yml", ({"data": 4}, {"fsdp": 2,
                                                      "tensor": 2})),
                   ("dit_v4_sf.yml", ({"data": 4},)),
                   ("dit_v4_prune.yml", ({"data": 4},)))
DISTILL_STEPS = 2


def distill_config(path, mesh, world, tag="distill"):
    """A distillation config with the run's cuts (seeded cores: no
    checkpoint exists; accumulation 1; the case's mesh), printed."""
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.train import port_cuts
    cfg = Config.from_yaml(path)
    tc = cfg.train
    cuts = chip_smoke.Cuts()
    cut = cuts.cut
    if tc.get("teacher_cfg"):
        cut(tc, "teacher_cfg", os.path.join(ROOT, tc.teacher_cfg),
            "the same file, from the repository root")
    for key in ("teacher_ckpt", "student_ckpt"):
        if tc.get(key):
            cut(tc, key, None, "no checkpoint exists: seeded cores")
    if (tc.opt or "").lower() == "muon":
        cut(tc, "opt", "AdamW", "the reference's build_simple_opt rejects "
            "Muon (owl_audio_exps_tpu/trainers/distill_common.py:68)")
    cut(tc, "mesh", dict(mesh), "the case")
    batch_ranks = mesh.get("data", 1) * mesh.get("fsdp", 1)
    if tc.batch_size != 1:
        cut(tc, "batch_size", 1, "one sample a micro-batch")
    cut(tc, "target_batch_size", batch_ranks, "accumulation 1")
    cuts.no_checkpoint(tc, WORK, "no checkpoint or eval in this run",
                       sample_interval=10 ** 9)
    cuts += port_cuts(cfg, world)
    cuts.show(f"[{tag}] cut from {os.path.relpath(path, ROOT)}")
    return cfg


def counted_distill(base, on_card):
    """The distillation trainer ``base`` with every critic, student or ODE
    step counted (kernel launches) and timed."""

    class Counted(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.calls = []

        def init_distill_state(self):
            state = super().init_distill_state()
            from owl_audio_exps_tpu_torch.parallel.sharding import \
                gather_params
            self.initial_student = {
                n: t.cpu() for n, t in gather_params(state.student).items()}
            return state

        def _counted(self, kind, step, *a):
            chip_smoke.reset_counts()
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(*a)
            metrics = {k: float(v) for k, v in metrics.items()}
            self.calls.append(dict(kind=kind, s=time.perf_counter() - t0,
                                   counts=chip_smoke.kernel_counts(),
                                   metrics=metrics))
            return metrics

        def critic_step(self, *a):
            return self._counted("critic", super().critic_step, *a)

        def student_step(self, *a):
            return self._counted("student", super().student_step, *a)

        def step(self, *a):
            return self._counted("ode", super().step, *a)

    return Counted


def distill_run(path, mesh, world, device, on_card):
    from owl_audio_exps_tpu_torch.parallel.sharding import gather_params
    from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
    cfg = distill_config(path, mesh, world)
    cls = counted_distill(get_trainer_cls(cfg.train.trainer_id), on_card)
    if "fsdp" in mesh:          # held against one card
        cls = chip_smoke.recording_grads(cls)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    trainer = cls(cfg, device=device)
    t0 = time.perf_counter()
    state = trainer.train(max_steps=DISTILL_STEPS)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 \
        if on_card else None
    L = cfg.train.data_kwargs.window_length * cfg.model.tokens_per_frame
    expect = (chip_smoke.distill_expect(trainer, L) if on_card else
              {k: dict.fromkeys(chip_smoke.kernel_counts(), 0)
               for k in ("critic", "student", "ode")})
    failures, by_kind = [], {}
    for i, call in enumerate(trainer.calls):
        if not all(math.isfinite(v) for v in call["metrics"].values()):
            failures.append(f"{path} {mesh_name(mesh)} {call['kind']} step "
                            f"{i + 1}: metrics not finite")
        if call["counts"] != expect[call["kind"]]:
            failures.append(f"{path} {mesh_name(mesh)} {call['kind']} step "
                            f"{i + 1}: launches {call['counts']}, expected "
                            f"{expect[call['kind']]}")
        by_kind.setdefault(call["kind"], []).append(call["s"])
    m = trainer.mesh
    out = dict(config=os.path.basename(path), mesh=dict(mesh),
               batch_rank=m.batch_rank, wall_s=wall, peak_gib=peak,
               step_s={k: statistics.median(v[1:] or v)
                       for k, v in by_kind.items()},
               k1_per_step={k: {n: e[n] for n in chip_smoke.K1_NAMES}
                            for k, e in expect.items() if k in by_kind},
               metrics=[c["metrics"] for c in trainer.calls],
               failures=failures)
    if "fsdp" in mesh:
        out["student"] = {k: v.cpu() for k, v in
                          gather_params(state.student, m).items()}
        out["initial_student"] = trainer.initial_student
        out["grads"] = distill_grads(trainer, state)
    del state, trainer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return out


def distill_grads(trainer, state):
    """The critic's and the student's first gradients (``recording_grads``),
    each name prefixed by its core's."""
    return {f"{core}.{n}": g for core in ("critic", "student")
            for n, g in chip_smoke.first_grads(
                trainer, getattr(state, core)).items()}


def distill_reference(path, run, world, device, on_card):
    """Rank 0 alone: the sharded CausVid run's steps on its card, each
    step's micro-batches those of every batch rank (its shard of the data)
    drawn with that rank's generator."""
    from owl_audio_exps_tpu_torch.data import get_loader
    from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
    mesh = run["mesh"]
    B = mesh.get("data", 1) * mesh.get("fsdp", 1)
    cfg = distill_config(path, {}, 1, tag="distill-parity")
    tc = cfg.train
    tc.target_batch_size = B
    base = chip_smoke.recording_grads(
        counted_distill(get_trainer_cls(tc.trainer_id), on_card))

    class PerRank(base):
        def accumulate(self, core, loss_fn, micro_batches, draws=None):
            def per_rank(mb, d):
                self.generator = self.gens[self.mb % B]
                self.mb += 1
                return loss_fn(mb, d)
            return super().accumulate(core, per_rank, micro_batches, draws)

    trainer = PerRank(cfg, device=device)
    trainer.mb = 0
    trainer.gens = [torch.Generator(device=device).manual_seed(
        trainer.SEED + b) for b in range(B)]
    loaders = [iter(get_loader(tc.data_id, tc.batch_size,
                               **dict(tc.data_kwargs.items()),
                               process_index=b, process_count=B))
               for b in range(B)]

    def stream():
        while True:
            for it in loaders:
                yield trainer.to_device(next(it))

    trainer.data_stream = lambda *a, **kw: stream()
    state = trainer.train(max_steps=DISTILL_STEPS)
    ref = {k: v.detach().cpu() for k, v in state.student.named_parameters()}

    keys = ("critic_loss", "dmd_loss", "ode_loss")
    losses = [{k: m[k] for k in keys if k in m} for m in run["metrics"]]
    ref_losses = [{k: c["metrics"][k] for k in keys if k in c["metrics"]}
                  for c in trainer.calls]
    loss_rel = max(abs(a[k] - b[k]) / abs(b[k])
                   for a, b in zip(losses, ref_losses) for k in b)
    return dict(**chip_smoke.parity_verdict(
        loss_rel, run["student"], ref, run["initial_student"], run["grads"],
        distill_grads(trainer, state)),
        losses=losses, ref_losses=ref_losses)


def case_main(args):
    from owl_audio_exps_tpu_torch.parallel import dist as pdist
    from owl_audio_exps_tpu_torch.parallel import mesh as pmesh
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("FAILED: no CUDA device", flush=True)
        sys.exit(2)
    if on_card:
        from owl_audio_exps_tpu_torch.ops import _build
        _build.build_all()
    local_rank = pdist.init_distributed(args.device)
    world, rank = pdist.process_count(), pdist.process_index()
    device = torch.device(f"cuda:{local_rank}" if on_card else "cpu")
    main_rank = rank == 0
    if main_rank and on_card:
        import subprocess
        say("cards: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().replace("\n", " | "))
    runs, checks = {}, []
    if args.case == "pipe":
        table = write_window_table(args, rank)
        if not args.parity_only:
            rep = runs["train"] = pipe_train(args, table, world, device,
                                             on_card, save=True)
            print(f"[pipe] rank {rank} (stage {rep['stage']}, blocks "
                  f"{rep['blocks']}): steps " + " ".join(
                      f"{x:.3f}" for x in rep["steps_s"]) + " s, peak "
                  + (f"{rep['peak_gib']:.2f} GiB" if on_card else "n/a")
                  + f", launches {rep['launches_per_step']}"
                  + (f", traced step {rep['trace']}" if rep.get("trace")
                     else "")
                  + (f", checkpoint {rep['checkpoint']}"
                     if rep.get("checkpoint") else "")
                  + f", failures {rep['failures']}", flush=True)
        checks.append(pipe_train(args, table, world, device, on_card,
                                 PIPE_CHECK_LAYERS, check_frames(args),
                                 "parity"))
    else:
        paths = (args.distill_configs.split(",") if args.distill_configs
                 else [os.path.join(ROOT, "configs", n)
                       for n, _ in DISTILL_CONFIGS])
        meshes = dict(DISTILL_CONFIGS)
        for path in paths:
            for mesh in meshes.get(os.path.basename(path), ({"data": 4},)):
                if args.parity_only and "fsdp" not in mesh:
                    continue
                name = f"{os.path.basename(path)} {mesh_name(mesh)}"
                t0 = time.perf_counter()
                runs[name] = r = distill_run(path, mesh, world, device,
                                             on_card)
                print(f"[distill] {name} rank {rank}: steps {r['step_s']} "
                      f"s, peak " + (f"{r['peak_gib']:.2f} GiB"
                                     if on_card else "n/a")
                      + f", K1 a step {r['k1_per_step']}, failures "
                      f"{r['failures']}", flush=True)
                if main_rank:
                    say(f"{name}: {DISTILL_STEPS} outer steps in "
                        f"{time.perf_counter() - t0:.1f} s")
                if "fsdp" in mesh:
                    checks.append((path, r))
    gathered = [None] * world
    light = {k: {kk: vv for kk, vv in v.items()
                 if kk not in ("student", "params", "initial_student",
                               "grads", "watch")}
             for k, v in runs.items()}
    dist.all_gather_object(gathered, light)
    pdist.cleanup()
    pmesh.make_mesh()
    bad = [f for rep in gathered for r in rep.values() for f in r["failures"]]
    if not main_rank:
        sys.exit(1 if bad else 0)
    parity = {}
    if args.case == "pipe":
        res = parity[f"{PIPE_CHECK_LAYERS} layers"] = pipe_reference(
            args, table, world, device, checks[0])
    else:
        for path, run in checks:
            res = parity[f"{os.path.basename(path)} "
                         f"{mesh_name(run['mesh'])}"] = distill_reference(
                path, run, world, device, on_card)
    for name, res in parity.items():
        say(f"parity {name}: " + ", ".join(
            f"{k} {v}" for k, v in res.items()))
        bad += [f"parity {name}: {f}" for f in res["failures"]]
    shutil.rmtree(WORK, ignore_errors=True)
    for f in bad:
        print(f"FAILED: {f}", flush=True)
    print(json.dumps(dict(ok=not bad, world=world, case=args.case,
                          runs=gathered, parity=parity)), flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
