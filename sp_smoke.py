"""Context-parallel training run of the port across cards (or CPU
processes), through its training entry point.

Usage (from the repository root, one process per card):

    torchrun --nproc_per_node 4 sp_smoke.py [--config_path configs/dit_v4_98k_sp.yml] [--max_steps 2]

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
loss is finite and that the launches are exact, and prints one JSON line
last. Exits non-zero on any failure.
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


def expected_counts(cfg, n: int, accum: int, on_card: bool):
    """Launches per step on every rank of an n-way seq split: each
    attention forward of a global layer (nn/attn.py
    attention_forwards_per_step: 3 for the first layer of a remat group)
    runs n ring partials and its backward recomputes n - 1; each of a
    local layer's forwards runs the band over [halo | slice] once."""
    from owl_audio_exps_tpu_torch.nn.attn import (attention_forwards_per_step,
                                                  local_layer_flags)
    fwd = attention_forwards_per_step(cfg)
    flags = local_layer_flags(cfg)
    n_global = len(flags) - sum(flags)
    per_micro = {
        "ring_partial_fwd": sum(f * n + n - 1
                                for f, local in zip(fwd, flags) if not local),
        "ring_partial_bwd_dq": n * n_global,
        "ring_partial_bwd_dkv": n * n_global,
        "band_attention_fwd": sum(f for f, local in zip(fwd, flags) if local),
        "band_attention_bwd": sum(flags)}
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


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_path",
                        default=os.path.join("configs", "dit_v4_98k_sp.yml"))
    parser.add_argument("--max_steps", type=int, default=2)
    parser.add_argument("--device", default="cuda", help="cuda or cpu")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.data import get_loader
    from owl_audio_exps_tpu_torch.parallel import dist as pdist
    from owl_audio_exps_tpu_torch.train import port_cuts
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
    cuts = port_cuts(cfg, world)
    tc = cfg.train
    for key, value in dict(log_interval=1, save_interval=10 ** 9,
                           checkpoint_dir=os.path.join(work, "ckpt"),
                           output_path=None).items():
        cuts.append(f"{key} {tc.get(key)!r} -> {value!r}")
        tc[key] = value
    if main_rank:
        for line in cuts:
            print(f"[sp] cut: {line}", flush=True)
        if on_card:
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
    expect = expected_counts(cfg.model, mesh.seq, accum, on_card)
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
    reports = [None] * world
    if world > 1:
        dist.all_gather_object(reports, report)
    else:
        reports[0] = report
    pdist.cleanup()
    if not main_rank:
        sys.exit(1 if any(r["failures"] for r in reports) else 0)

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
                          tokens_per_s=tokens / step_s, reports=reports)),
          flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
