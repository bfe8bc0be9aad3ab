"""Context-parallel training run of the port across cards (or CPU
processes), through its training entry point.

Usage (from the repository root, one process per card):

    torchrun --nproc_per_node 4 sp_smoke.py [--config_path configs/dit_v4_98k_sp.yml] [--max_steps 2]

and the AV model (configs/av_v5_8x8_weak.yml, which names no seq axis:
``sequence_parallel`` and ``mesh: {seq: 4}`` are cut in, printed) at
1,536 frames, batch 1 a rank, group remat, with a 4-layer full-width copy
at 384 frames held against one card:

    torchrun --nproc_per_node 4 sp_smoke.py --config_path configs/av_v5_8x8_weak.yml --frames 1536 --remat group --check_layers 4 --check_frames 384

and on the CPU (gloo), with a small config:

    torchrun --nproc_per_node 4 sp_smoke.py --config_path <cfg> --device cpu

Every process builds the trainer as ``python -m
owl_audio_exps_tpu_torch.train`` does (the same cuts, printed), logs
every step, and counts the kernel launches of each step (chip_smoke.py's
counted trainer). Then one more step of one micro-batch is traced on
every rank (device time by kernel class, NCCL included). Each rank
reports its step times, its peak device memory and its launches per step
against the count the remat structure and the ring give; rank 0 checks
that every rank holds the same parameters after the steps, that every
loss is finite and that the launches are exact. With ``--check_layers``
a copy of that depth at ``--check_frames`` frames takes the same steps,
and after the process group is left rank 0 takes them on its card
unsplit, held by chip_smoke.py ``parity_verdict``: the losses 1e-2
relative, every parameter's first gradient 0.1 relative L2, the whole
model's update 0.25 (the parameters and the worst single one are
reported). Rank 0 prints one JSON line last. Exits
non-zero on any failure.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time

import torch
import torch.distributed as dist

import chip_smoke

ROOT = os.path.dirname(os.path.abspath(__file__))


def expected_counts(cfg, n: int, accum: int, on_card: bool, L_loc: int):
    """Launches per step on every rank of an n-way seq split of L_loc
    tokens a rank: each attention forward of a global layer (nn/attn.py
    attention_forwards_per_step: 3 for the first layer of a remat group)
    runs n ring partials and its backward recomputes n - 1; each of a
    local layer's forwards runs the band over [halo | slice] once (the
    first rank over its slice alone, through the same kernel)."""
    from owl_audio_exps_tpu_torch.nn.attn import (attention_forwards_per_step,
                                                  local_layer_flags)
    from owl_audio_exps_tpu_torch.parallel.context import halo_band_route
    fwd = attention_forwards_per_step(cfg)
    flags = local_layer_flags(cfg)
    n_global = len(flags) - sum(flags)
    # the band kernel of the [halo | slice] span (K2 at tpf 64, K5 at 65)
    C = cfg.local_window * cfg.tokens_per_frame
    band = halo_band_route(L_loc + C, cfg.tokens_per_frame,
                           cfg.local_window)[0] + "_attention"
    per_micro = {
        "ring_partial_fwd": sum(f * n + n - 1
                                for f, local in zip(fwd, flags) if not local),
        "ring_partial_bwd_dq": n * n_global,
        "ring_partial_bwd_dkv": n * n_global,
        f"{band}_fwd": sum(f for f, local in zip(fwd, flags) if local),
        f"{band}_bwd": sum(flags)}
    # the CPU runs plain versions, which count nothing; K1 is not on this path
    return {k: per_micro.get(k, 0) * accum * on_card
            for k in chip_smoke.kernel_counts()}


def trace_step(step):
    """Device time (ms) by kernel class of one traced call of ``step``,
    and its wall time (ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    classes = dict.fromkeys(("K4 fwd", "K4 bwd", "band", "nccl send/recv",
                             "nccl all-reduce", "nccl other", "matmul",
                             "other"), 0.0)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False):
            continue
        n, us = e.name, e.time_range.elapsed_us()
        if "ring_attn_fwd" in n:
            classes["K4 fwd"] += us
        elif "ring_attn_bwd" in n:
            classes["K4 bwd"] += us
        elif "band_attn" in n:
            classes["band"] += us
        elif "nccl" in n.lower():
            kind = ("send/recv" if "sendrecv" in n.lower() else
                    "all-reduce" if "allreduce" in n.lower() else "other")
            classes[f"nccl {kind}"] += us
        elif any(t in n.lower() for t in ("gemm", "nvjet", "cutlass",
                                          "sm90_xmma")):
            classes["matmul"] += us
        else:
            classes["other"] += us
    return {k: v / 1e3 for k, v in classes.items()}, wall * 1e3


def sp_cuts(cfg, args, world: int, work: str, n_layers=None,
            frames=None, seq=None):
    """The entry point's cuts (train.py port_cuts) and the run's, on
    ``cfg`` in place; returns one line each. A config that names no seq
    axis (the AV model's) gets ``sequence_parallel`` and the seq axis over
    the processes; ``--frames`` cuts the window, ``--remat`` turns
    gradient checkpointing on, and a window of more frames than the
    config's batch fits is cut to batch 1 a rank."""
    from owl_audio_exps_tpu_torch.train import port_cuts
    m, tc = cfg.model, cfg.train
    cuts = chip_smoke.Cuts()
    cut = cuts.cut
    mesh = dict((tc.get("mesh") or {}).items())
    if not m.get("sequence_parallel"):
        cut(m, "sequence_parallel", True, "the context-parallel run")
    if mesh.get("seq", 1) == 1:
        cut(tc, "mesh", dict(mesh, data=1, seq=seq or world),
            "the seq axis over the processes")
    cuts += port_cuts(cfg, world)
    frames = frames or args.frames
    if frames:
        kw = dict(tc.data_kwargs.items())
        if kw.get("window_length") != frames:
            cut(tc, "data_kwargs", dict(kw, window_length=frames),
                f"{frames} frames")
            cut(m, "n_frames", max(m.n_frames, frames), "the window")
        if tc.batch_size > 1:
            cut(tc, "batch_size", 1, "one sample a rank at this window")
        data = dict(tc.mesh.items()).get("data", 1)
        if tc.target_batch_size != data:
            cut(tc, "target_batch_size", data, "accumulation 1")
    if args.remat and not m.get("gradient_checkpointing"):
        cut(m, "gradient_checkpointing", True,
            f"{args.remat} remat (as the one-card AV run)")
        if args.remat == "group":
            cut(m, "remat_granularity", "group", "group remat")
    if n_layers is not None:
        cut(m, "n_layers", n_layers, "the parity copy")
    cuts.no_checkpoint(tc, work)
    return cuts


def check_run(args, world, work, device):
    """The ``--check_layers`` copy's steps at ``--check_frames`` under the
    run's mesh; returns its parameters (alike on every rank) and logged
    losses, on the host."""
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
    cfg = Config.from_yaml(args.config_path)
    cuts = sp_cuts(cfg, args, world, work, n_layers=args.check_layers,
                   frames=args.check_frames)
    cuts.show("[sp] parity cut")
    trainer = chip_smoke.recording_grads(
        get_trainer_cls(cfg.train.trainer_id))(cfg, device=device)
    state = trainer.train(max_steps=args.max_steps)
    params = {k: v.detach().cpu().clone()
              for k, v in state.model.named_parameters()}
    losses = [h["diffusion_loss"] for h in trainer.logger.history]
    return dict(params=params, losses=losses,
                grads=chip_smoke.first_grads(trainer, state.model))


def check_reference(args, world, work, device, run):
    """Rank 0 alone: the copy's steps unsplit on its card (one process:
    the seq axis and sequence parallelism cut away), from the same
    weights, batches and draws."""
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
    cfg = Config.from_yaml(args.config_path)
    sp_cuts(cfg, args, world, work, n_layers=args.check_layers,
            frames=args.check_frames)
    cfg.model.sequence_parallel = False
    cfg.train.mesh = {}
    trainer = chip_smoke.recording_grads(
        get_trainer_cls(cfg.train.trainer_id))(cfg, device=device)
    init = {k: v.detach().cpu().clone()
            for k, v in trainer.init_state().model.named_parameters()}
    state = trainer.train(max_steps=args.max_steps)
    ref = {k: v.detach().cpu() for k, v in state.model.named_parameters()}
    losses = [h["diffusion_loss"] for h in trainer.logger.history]
    return dict(**chip_smoke.parity_verdict(
        max(abs(a - b) / abs(b) for a, b in zip(run["losses"], losses)),
        run["params"], ref, init, run["grads"],
        chip_smoke.first_grads(trainer, state.model)),
        losses=run["losses"], ref_losses=losses)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_path",
                        default=os.path.join("configs", "dit_v4_98k_sp.yml"))
    parser.add_argument("--max_steps", type=int, default=2)
    parser.add_argument("--device", default="cuda", help="cuda or cpu")
    parser.add_argument("--frames", type=int, default=None,
                        help="cut the data window to this many frames")
    parser.add_argument("--remat", default=None,
                        help="'group' or 'block': cut gradient "
                        "checkpointing in at that granularity")
    parser.add_argument("--check_layers", type=int, default=0,
                        help="a copy of this depth held against one card")
    parser.add_argument("--check_frames", type=int, default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.data import get_loader
    from owl_audio_exps_tpu_torch.parallel import dist as pdist
    from owl_audio_exps_tpu_torch.trainers import get_trainer_cls

    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("FAILED: no CUDA device", flush=True)
        sys.exit(2)
    cfg = Config.from_yaml(args.config_path)
    local_rank = pdist.init_distributed(args.device)
    world, rank = pdist.process_count(), pdist.process_index()
    device = f"cuda:{local_rank}" if on_card else "cpu"
    main_rank = rank == 0
    work = os.path.join(ROOT, "build", "sp_smoke")
    cuts = sp_cuts(cfg, args, world, work)
    tc = cfg.train
    cuts.show("[sp] cut")
    if main_rank and on_card:
        import subprocess
        print("[sp] " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().replace("\n", " | "), flush=True)

    failures = []
    base = get_trainer_cls(tc.trainer_id)
    CountedTrainer = chip_smoke.counted_trainer(base)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    trainer = CountedTrainer(cfg, device=device)
    mesh = trainer.mesh
    accum = trainer.accum_steps()
    t0 = time.perf_counter()
    state = trainer.train(max_steps=args.max_steps)
    wall = time.perf_counter() - t0
    peak_gib = (torch.cuda.max_memory_allocated(device) / 2 ** 30
                if on_card else None)
    L_loc = (tc.data_kwargs.window_length * cfg.model.tokens_per_frame
             // mesh.seq)
    expect = expected_counts(cfg.model, mesh.seq, accum, on_card, L_loc)
    for i, st in enumerate(trainer.steps):
        if not math.isfinite(st["loss"]):
            failures.append(f"rank {rank} step {i + 1}: loss not finite")
        if st["counts"] != expect:
            failures.append(f"rank {rank} step {i + 1}: launches "
                            f"{st['counts']}, expected {expect}")

    # every rank must hold the same parameters after the steps
    with torch.no_grad():
        sums = torch.stack([p.detach().double().sum()
                            for p in state.model.parameters()])
    gathered = [sums]
    if world > 1:
        gathered = [torch.empty_like(sums) for _ in range(world)]
        dist.all_gather(gathered, sums)
    same = all(torch.equal(g, gathered[0]) for g in gathered)
    if not same:
        failures.append("the ranks' parameters differ after the steps")

    trace = None
    if on_card:
        loader = iter(get_loader(tc.data_id, tc.batch_size,
                                 **dict(tc.data_kwargs.items(),
                                        process_index=mesh.data_index)))
        micro = [trainer.to_device(next(loader))]
        gen = torch.Generator(device=device).manual_seed(99)
        classes, trace_ms = trace_step(
            lambda: base.train_step(trainer, state, micro, gen))
        trace = dict(wall_ms=trace_ms, device_ms=classes,
                     busy_ms=sum(classes.values()))

    report = dict(rank=rank, seq_index=mesh.seq_index, data_index=mesh.data_index,
                  steps_s=[st["s"] for st in trainer.steps],
                  losses=[st["loss"] for st in trainer.steps],
                  launches_per_step=trainer.steps[-1]["counts"]
                  if trainer.steps else None,
                  expected_launches=expect, peak_gib=peak_gib, trace=trace,
                  failures=failures)
    del state, trainer
    check = None
    if args.check_layers:
        check = check_run(args, world, work, device)
    reports = [None] * world
    if world > 1:
        dist.all_gather_object(reports, report)
    else:
        reports[0] = report
    pdist.cleanup()
    if not main_rank:
        sys.exit(1 if any(r["failures"] for r in reports) else 0)
    parity = None
    if check is not None:
        from owl_audio_exps_tpu_torch.parallel import mesh as pmesh
        pmesh.make_mesh()        # one process from here on
        parity = check_reference(args, world, work, device, check)
        print(f"[sp] parity: {args.check_layers}-layer copy at "
              f"{args.check_frames} frames, {args.max_steps} steps: losses "
              f"{parity['losses']} vs one card {parity['ref_losses']} (worst "
              f"rel {parity['loss_rel']:.3e}, limit "
              f"{chip_smoke.PARITY_LOSS_REL}); the worst first gradient "
              f"{parity['worst_grad']} rel L2 {parity['grad_rel_l2']:.3e} "
              f"(limit {chip_smoke.PARITY_GRAD_REL}, {parity['grads_held']} "
              f"held, skipped {parity['grads_skipped']}); the update rel L2 "
              f"{parity['update_rel_l2']:.3e} (limit "
              f"{chip_smoke.PARITY_UPDATE_REL}); parameters rel L2 "
              f"{parity['param_rel_l2']:.3e}, the worst "
              f"{parity['worst_param']} {parity['worst_param_rel_l2']:.3e}",
              flush=True)
        reports[0]["failures"] += [f"parity: {f}"
                                   for f in parity["failures"]]

    m = cfg.model
    sample = tc.data_kwargs.window_length * m.tokens_per_frame
    tokens = sample * tc.batch_size * accum * mesh.data
    for r in reports:
        print(f"[sp] rank {r['rank']} (seq {r['seq_index']}): steps "
              + " ".join(f"{s:.3f}" for s in r["steps_s"]) + " s, losses "
              + " ".join(f"{x:.5f}" for x in r["losses"])
              + (f", peak {r['peak_gib']:.2f} GiB" if on_card else "")
              + f", launches per step {r['launches_per_step']}", flush=True)
        if r["trace"]:
            t = r["trace"]
            print(f"[sp]   traced step of 1 micro-batch: wall "
                  f"{t['wall_ms']:.1f} ms, device busy {t['busy_ms']:.1f} "
                  "ms: " + ", ".join(f"{k} {v:.1f}"
                                     for k, v in t["device_ms"].items()),
                  flush=True)
    # the ranks meet at every exchange, so rank 0's step is the step;
    # the first step, which warms up, is left out when there are more
    times = reports[0]["steps_s"]
    step_s = statistics.median(times[1:] or times)
    print(f"[sp] {m.n_layers} layers x d {m.d_model}, {mesh.seq} seq x "
          f"{mesh.data} data ranks, {sample} tokens a sample, {accum} "
          f"micro-batches a step: {args.max_steps} steps in {wall:.1f} s; "
          f"step {step_s:.3f} s (median of steps {2 if len(times) > 1 else 1}"
          f"-{len(times)}), {tokens / step_s:.0f} tokens/s; same parameters "
          f"on every rank: {same}", flush=True)
    bad = [f for r in reports for f in r["failures"]]
    for f in bad:
        print(f"FAILED: {f}", flush=True)
    print(json.dumps(dict(ok=not bad, world=world, step_s=step_s,
                          tokens_per_s=tokens / step_s, reports=reports,
                          parity=parity)), flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
