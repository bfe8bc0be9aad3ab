"""On-card smoke run of the PyTorch/CUDA port (owl_audio_exps_tpu_torch).

Usage (from the repository root, on a machine with one NVIDIA GPU):

    python3 chip_smoke.py

Phases, each of which exits non-zero on any failure:

1. environment: card name and power limit, torch version, nvcc build of
   every kernel under owl_audio_exps_tpu_torch/csrc/ (build time printed);
2. each kernel against its plain PyTorch version on the card, at the
   geometries the serve paths give it, with its time, the plain
   version's time, its bound and the time of one library call that
   computes the same function (a yardstick the port never calls);
3. ``CausvidPipeline`` (window recompute, 60 frames x 65 tokens) at the
   full width of configs/av_v4_8x8.yml made causal (24 layers x 1536,
   24 heads x 64), 2 sampling steps, seeded random bf16 weights: timed
   ticks, one traced tick (device time by kernel class), and one forward
   through the kernel held against the dense attention route;
4. ``AVWindowSampler`` on configs/av_v4_8x8.yml as written, with the
   step and frame counts cut for time (printed).

The last lines are the kernels' JSON record, the card line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (data sheet)
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
# kernel vs plain version (f32 on the same bf16 inputs): the kernel
# rounds P to bf16 before PV and writes bf16 output (2^-9 relative)
KERNEL_MAX_ABS, KERNEL_MEAN_ABS = 2e-2, 2e-3
# full-width core forward, kernel vs dense attention, relative L2 error
FORWARD_REL_L2 = 5e-2
SERVE_TICKS = 6   # timed ticks after one warm tick


def fail(msg: str):
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- phase 2
KERNEL_CASES = [
    # name, L, tpf, causal, window, two documents
    ("L3900_causal_w16", 3900, 65, True, 16, False),
    ("L3900_causal_global", 3900, 65, True, None, False),
    ("L1040_bidir_w16", 1040, 65, False, 16, False),
    ("L3900_causal_w16_2docs", 3900, 65, True, 16, True),
    ("L4096_tpf64_causal_w16", 4096, 64, True, 16, False),
]


def kernel_phase(dev):
    import torch.nn.functional as F
    from owl_audio_exps_tpu_torch.ops import splash
    from owl_audio_exps_tpu_torch.ops.masks import dense_mask

    B, H, Dh = 1, 24, 64
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for name, L, tpf, causal, window, two_docs in KERNEL_CASES:
        q, k, v = (torch.randn(B, H, L, Dh, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        nf = -(-L // tpf)
        doc = None
        if two_docs:
            doc = (torch.arange(nf, device=dev) >= nf // 3).int()[None]
        args = (tpf, window, causal, doc)
        out = splash.splash_attention(q, k, v, *args)
        torch.cuda.synchronize()
        ref = splash.splash_attention_plain(q.float(), k.float(), v.float(),
                                            *args)
        err = (out.float() - ref).abs()
        max_abs, mean_abs = err.max().item(), err.mean().item()
        if not torch.isfinite(out).all():
            fail(f"{name}: kernel output not finite")

        ms = cuda_ms(lambda: splash.splash_attention(q, k, v, *args), 20)
        plain_ms = cuda_ms(
            lambda: splash.splash_attention_plain(q, k, v, *args), 3, 1)
        mask = dense_mask(L, tpf, window, None if doc is None else doc.long(),
                          0, causal, device=dev)
        mask = mask[None, None] if mask.ndim == 2 else mask[:, None]
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=Dh ** -0.5), 10)

        pairs = sum(splash.visible_pairs(
            L, tpf, window, causal, None if doc is None else doc[b].tolist())
            for b in range(B))
        flops = 4.0 * Dh * pairs * H
        nbytes = 4.0 * B * H * L * Dh * 2
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        row = dict(max_abs_err=max_abs, mean_abs_err=mean_abs, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=1e3 * max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   gflop=flops / 1e9, tflops=flops / (ms * 1e-3) / 1e12)
        rows[name] = row
        print(f"[kernel] {name}: B={B} H={H} L={L} Dh={Dh} tpf={tpf} "
              f"causal={causal} window={window} docs={2 if two_docs else 1} "
              f"| max|d|={max_abs:.3e} mean|d|={mean_abs:.3e} | kernel "
              f"{ms:.4f} ms ({row['tflops']:.1f} TFLOP/s), plain "
              f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
              f"{1e3 * row['bound_ms']:.2f} us ({row['bound_by']}, "
              f"{row['gflop']:.2f} GFLOP)", flush=True)
        if max_abs > KERNEL_MAX_ABS or mean_abs > KERNEL_MEAN_ABS:
            fail(f"{name}: kernel disagrees with its plain version "
                 f"(max {max_abs:.3e} > {KERNEL_MAX_ABS} or mean "
                 f"{mean_abs:.3e} > {KERNEL_MEAN_ABS})")
        del q, k, v, out, ref, err, mask
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- phase 3
def serve_config():
    from owl_audio_exps_tpu_torch.configs import transformer_config
    return transformer_config(
        model_id="game_rft_audio", sample_size=8, channels=128,
        audio_channels=64, n_layers=24, n_heads=24, d_model=1536,
        tokens_per_frame=65, n_buttons=11, cfg_prob=0.0, n_frames=256,
        causal=True, uncond=False, backbone="dit", has_audio=True,
        rope_impl="ortho", local_window=16, global_window=None)


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def profile_tick(pipe, ctrl, tick_ms: float):
    """Trace one tick: device time by kernel class, and its busy share of
    the untraced median tick ``tick_ms`` (one stream, so kernel times do
    not overlap; tracing slows the host, so the traced tick's own wall
    time is longer)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprof

    with tprof(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        _, _, wall_s = pipe(*ctrl)
    per_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_us = sum(us for us, _ in per_name.values())
    if busy_us == 0:
        fail("the profiler recorded no device time")
    classes = {"frame attention kernel": 0.0, "matmul (cuBLAS)": 0.0,
               "other (elementwise, norms, copies)": 0.0}
    for name, (us, _) in per_name.items():
        if "frame_attn" in name:
            classes["frame attention kernel"] += us
        elif any(s in name.lower() for s in ("gemm", "nvjet", "cutlass",
                                              "sm90_xmma")):
            classes["matmul (cuBLAS)"] += us
        else:
            classes["other (elementwise, norms, copies)"] += us
    print(f"[profile] one tick: device busy {busy_us / 1e3:.2f} ms = "
          f"{100 * busy_us / 1e3 / tick_ms:.1f}% of the untraced median "
          f"tick ({tick_ms:.2f} ms); traced wall {1e3 * wall_s:.2f} ms; "
          f"{sum(n for _, n in per_name.values())} kernels", flush=True)
    for cls, us in classes.items():
        print(f"[profile]   {cls}: {us / 1e3:.2f} ms "
              f"({100 * us / busy_us:.1f}% of busy)", flush=True)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (us, n) in top:
        print(f"[profile]   {us / 1e3:9.3f} ms {n:5d}x {name[:100]}",
              flush=True)
    return {k: us / 1e3 for k, us in classes.items()}


def pipeline_phase(dev, n_ticks: int):
    from owl_audio_exps_tpu_torch.inference.pipeline import CausvidPipeline
    from owl_audio_exps_tpu_torch.models.gamerft_audio import GameRFTAudioCore
    from owl_audio_exps_tpu_torch.ops import splash

    cfg = serve_config()
    t0 = time.perf_counter()
    core = GameRFTAudioCore(cfg, dtype=torch.bfloat16, device=dev,
                            seed=0).to(torch.bfloat16).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in core.parameters())
    print(f"[serve] core: {cfg.n_layers} layers x d {cfg.d_model}, "
          f"{cfg.n_heads} heads x {cfg.d_model // cfg.n_heads}, "
          f"{n_params / 1e6:.1f} M params bf16, init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    W, steps = 60, 2
    pipe = CausvidPipeline(core, cfg, window_length=W, sampling_steps=steps,
                           seed=0, device=dev)
    ctrl_gen = torch.Generator().manual_seed(1)

    def controls(i):
        mouse = [0.1 * ((i % 7) - 3), 0.05 * ((i % 5) - 2)]
        btn = (torch.rand(cfg.n_buttons, generator=ctrl_gen) > 0.5).float()
        return mouse, btn.numpy()

    frame, audio, warm_s = pipe(*controls(0))
    print(f"[serve] warm tick {1e3 * warm_s:.1f} ms", flush=True)

    splash.launches = 0
    times = []
    for i in range(n_ticks):
        frame, audio, dt = pipe(*controls(i + 1))
        times.append(dt)
        if not (torch.isfinite(frame).all() and torch.isfinite(audio).all()):
            fail(f"tick {i}: non-finite output")
    main_launches = splash.launches
    expect = n_ticks * steps * cfg.n_layers
    if tuple(frame.shape) != (1, cfg.channels, 8, 8) or \
            tuple(audio.shape) != (1, cfg.audio_channels):
        fail(f"tick output shapes {tuple(frame.shape)} {tuple(audio.shape)}")
    if main_launches != expect:
        fail(f"frame attention kernel launched {main_launches} times in "
             f"{n_ticks} ticks, expected {expect}")
    ms = [1e3 * t for t in times]
    tick_ms = statistics.median(ms)
    print(f"[serve] CausvidPipeline W={W} L={W * 65} steps={steps}: "
          f"{n_ticks} ticks, ms/tick median {tick_ms:.2f} min {min(ms):.2f} "
          f"max {max(ms):.2f}; kernel launches {main_launches} "
          f"({main_launches // n_ticks}/tick)", flush=True)

    breakdown = profile_tick(pipe, controls(99), tick_ms)
    splash.launches = main_launches   # the traced tick is not counted

    # one full-width forward: kernel route against the dense route
    gen = torch.Generator(device=dev).manual_seed(2)
    bf = torch.bfloat16
    x = torch.randn(1, W, cfg.channels, 8, 8, generator=gen,
                    device=dev).to(bf)
    a = torch.randn(1, W, cfg.audio_channels, generator=gen,
                    device=dev).to(bf)
    ts = torch.full((1, W), 0.2, dtype=bf, device=dev)
    ts[:, -1] = 1.0
    m = torch.randn(1, W, 2, generator=gen, device=dev).to(bf)
    b = (torch.rand(1, W, cfg.n_buttons, generator=gen, device=dev)
         > 0.5).to(bf)
    before = splash.launches
    with torch.inference_mode():
        vk, ak = core(x, a, ts, m, b)
        cfg.attn_impl = "dense"
        vd, ad = core(x, a, ts, m, b)
        cfg.attn_impl = "auto"
    splash.launches = before
    ev, ea = rel_l2(vk, vd), rel_l2(ak, ad)
    print(f"[serve] full-width forward kernel vs dense attention: rel L2 "
          f"video {ev:.3e} audio {ea:.3e} (tolerance {FORWARD_REL_L2})",
          flush=True)
    if not (ev <= FORWARD_REL_L2 and ea <= FORWARD_REL_L2):
        fail("full-width forward through the kernel disagrees with dense")
    del core, pipe, x, a, vk, ak, vd, ad
    torch.cuda.empty_cache()
    return main_launches, tick_ms, breakdown


# ---------------------------------------------------------------- phase 4
def sampler_phase(dev):
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.models import get_core_cls
    from owl_audio_exps_tpu_torch.ops import splash
    from owl_audio_exps_tpu_torch.sampling import get_sampler_cls

    conf = Config.from_yaml(os.path.join(ROOT, "configs", "av_v4_8x8.yml"))
    cfg = conf.model
    kw = conf.train.sampler_kwargs.to_dict()
    cut = dict(n_steps=2, num_frames=2)
    print(f"[sampler] {conf.train.sampler_id} on configs/av_v4_8x8.yml, "
          f"reduced for time: n_steps {kw['n_steps']} -> {cut['n_steps']}, "
          f"num_frames {kw['num_frames']} -> {cut['num_frames']}", flush=True)
    kw.update(cut)
    core = get_core_cls(cfg.model_id)(cfg, dtype=torch.bfloat16, device=dev,
                                      seed=1).to(torch.bfloat16).eval()
    sampler = get_sampler_cls(conf.train.sampler_id)(**kw)
    W = sampler.window_length
    gen = torch.Generator(device=dev).manual_seed(3)
    bf = torch.bfloat16
    x = torch.randn(1, W, cfg.channels, cfg.sample_size, cfg.sample_size,
                    generator=gen, device=dev).to(bf)
    a = torch.randn(1, W, cfg.audio_channels, generator=gen,
                    device=dev).to(bf)
    m = torch.randn(1, W, 2, generator=gen, device=dev).to(bf)
    b = (torch.rand(1, W, cfg.n_buttons, generator=gen, device=dev)
         > 0.5).to(bf)

    splash.launches = 0
    t0 = time.perf_counter()
    _, _, x_out, a_out, _, _ = sampler(core, x, a, m, b, generator=gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = splash.launches
    expect = cut["num_frames"] * cut["n_steps"] * 2 * cfg.n_layers
    n_out = W + cut["num_frames"]
    if tuple(x_out.shape) != (1, n_out, cfg.channels, 8, 8) or \
            tuple(a_out.shape) != (1, n_out, cfg.audio_channels):
        fail(f"sampler output shapes {tuple(x_out.shape)} "
             f"{tuple(a_out.shape)}")
    if not (torch.isfinite(x_out).all() and torch.isfinite(a_out).all()):
        fail("sampler output not finite")
    if launches != expect:
        fail(f"frame attention kernel launched {launches} times, expected "
             f"{expect}")
    print(f"[sampler] AVWindowSampler W={W} L={W * cfg.tokens_per_frame} "
          f"causal={cfg.causal} cfg_scale={sampler.cfg_scale}: "
          f"{cut['num_frames']} frames in {secs:.2f} s; kernel launches "
          f"{launches}", flush=True)
    return launches


def main():
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device; this smoke run needs one GPU",
              flush=True)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    try:
        from owl_audio_exps_tpu_torch.ops import _build
    except ImportError as e:
        print(f"FAILED: the port package is not beside this script ({e})",
              flush=True)
        sys.exit(3)

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[env] {card}", flush=True)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all(verbose=True)
    print(f"[env] built {sorted(libs)} in {time.perf_counter() - t0:.1f} s "
          f"into {_build.build_dir()}", flush=True)

    rows = kernel_phase(dev)
    serve_launches, tick_ms, breakdown = pipeline_phase(dev, SERVE_TICKS)
    sampler_launches = sampler_phase(dev)

    main = rows["L3900_causal_w16"]
    record = {"kernels": [{
        "name": "frame_attention_fwd",
        "route": "cuda",
        "source": "owl_audio_exps_tpu_torch/csrc/frame_attention.cu",
        "replaces": "owl_audio_exps_tpu/ops/splash.py:237",
        "launches": serve_launches + sampler_launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "case": "B=1 H=24 L=3900 Dh=64 tpf=65 causal window=16",
        "cases": rows,
        "serve_tick_ms": tick_ms,
        "serve_tick_device_ms": breakdown,
    }]}
    print(json.dumps(record), flush=True)
    print(f"[env] {card_line()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
