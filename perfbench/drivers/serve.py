"""The serve driver: the port's cached audio-video game loop
(``inference/pipeline.py`` ``AVCachedStreamingPipeline``, the steady
tick replayed from its CUDA graph) for a closed loop of ``sessions``
players.

Set-up makes the weights and the context clip from the seed, primes the
ring full and runs ``warm_ticks`` ticks (the graph's warm-up and
capture). The window then runs ticks until ``--seconds`` have passed:
each tick draws its controls and noise from its own sub-seed, hands them
to the pipeline and ends when its frame and audio latent are on the
host; the next tick starts then. No count of ticks is fixed in advance.
Afterwards the reference (reference/serve.py) follows the first
``ref_ticks`` ticks (warm-up, then the window's; several RoPE rebases)
from the same inputs and each of those answers is compared with it.
"""

from __future__ import annotations

import copy
import statistics
import sys
import time

import numpy as np
import torch

from perfbench import flops as F
from perfbench.weights import load_into, make_weights, sub_seed


def bf_round(x):
    return x.to(torch.bfloat16).float()


def tick_seed(seed, i) -> int:
    """Tick ``i``'s sub-seed of ``seed``."""
    return (sub_seed(seed, "noise") * 1_000_003 + int(i)) % (2 ** 63 - 1)


class Driver:
    kind = "serve"

    def __init__(self, run):
        self.run = run
        self.cfg = copy.deepcopy(run.config)
        self.mc = self.cfg["model"]
        self.wl = run.workload
        self.tr = self.wl["traffic"]
        self.dev = run.device
        self.B = self.tr["sessions"]
        if self.B != 1:
            raise ValueError("the serve driver runs one session")

    # ------------------------------------------------------------ inputs
    def inputs(self):
        """The context clip and its draws, from the seed. Controls are
        bfloat16 values (the loop holds them so)."""
        mc, tr, dev = self.mc, self.tr, self.dev
        p, T = mc["sample_size"], tr["prime_frames"]
        g = torch.Generator(device=dev).manual_seed(sub_seed(self.run.seed,
                                                             "data"))
        return dict(lat=torch.randn(1, T, mc["channels"], p, p, generator=g,
                                    device=dev),
                    aud=torch.randn(1, T, mc["audio_channels"], generator=g,
                                    device=dev),
                    mouse=bf_round(torch.randn(1, T, 2, generator=g,
                                               device=dev)),
                    btn=(torch.rand(1, T, mc["n_buttons"], generator=g,
                                    device=dev) > 0.5).float(),
                    z_lat=torch.randn(1, T, mc["channels"], p, p,
                                      generator=g, device=dev),
                    z_aud=torch.randn(1, T, mc["audio_channels"],
                                      generator=g, device=dev))

    def tick_inputs(self, i):
        """Tick ``i``'s controls (mouse N(0,1) on 2 axes as bfloat16
        values, buttons Bernoulli 0.5) and its float32 draws (initial
        and re-noise, video and audio), from the tick's own sub-seed."""
        mc, dev = self.mc, self.dev
        p = mc["sample_size"]
        seed = tick_seed(self.run.seed, i)
        gn = torch.Generator(device=dev).manual_seed(seed)
        iv, rv = (torch.randn(1, 1, mc["channels"], p, p, generator=gn,
                              device=dev) for _ in range(2))
        ia, ra = (torch.randn(1, 1, mc["audio_channels"], generator=gn,
                              device=dev) for _ in range(2))
        rs = np.random.default_rng(seed)
        mouse = bf_round(torch.from_numpy(
            rs.standard_normal(2).astype(np.float32))).numpy()
        btn = (rs.random(mc["n_buttons"]) < 0.5).astype(np.float32)
        return mouse, btn, (iv, ia), (rv, ra)

    # ------------------------------------------------------------ set-up
    def setup(self):
        from owl_audio_exps_tpu_torch.configs import Config
        from owl_audio_exps_tpu_torch.inference.pipeline import (
            AVCachedStreamingPipeline, TickNoise)
        from owl_audio_exps_tpu_torch.models import get_core_cls
        from perfbench.reference.model import param_spec

        self.TickNoise = TickNoise
        conf = Config.from_dict({"model": self.mc,
                                 "train": self.cfg["train"]})
        core = get_core_cls(conf.model.model_id)(
            conf.model, dtype=torch.bfloat16, device=self.dev, seed=None)
        load_into(core, make_weights(param_spec(self.mc), self.run.seed,
                                     torch.bfloat16, self.dev))
        core = core.to(torch.bfloat16).eval()
        self.ctx = self.inputs()
        tr = self.tr
        self.pipe = AVCachedStreamingPipeline(
            core, conf.model, window_frames=tr["ring_frames"],
            noise_prev=tr["noise_prev"], sampling_steps=tr["steps"],
            seed=0, n_sessions=1, fused_write=True, device=self.dev,
            graphed=self.dev.type == "cuda")
        c = self.ctx
        self.pipe.prime(c["lat"], c["aud"], c["mouse"], c["btn"],
                        noise=(c["z_lat"], c["z_aud"]))
        self.outputs = []
        for _ in range(tr["warm_ticks"]):
            self.tick()

    def tick(self):
        """One tick of the closed loop: the next controls in, the answer
        on the host out; returns its milliseconds."""
        mouse, btn, init, renoise = self.tick_inputs(len(self.outputs))
        noise = self.TickNoise(init, renoise)
        t0 = time.perf_counter()
        frame, audio, _ = self.pipe(mouse, btn, noise)
        out = (frame.cpu(), audio.cpu())
        ms = 1e3 * (time.perf_counter() - t0)
        self.outputs.append(out)
        return ms

    # ------------------------------------------------------------ window
    def window(self, seconds):
        setup_peak = 0
        if self.dev.type == "cuda":
            setup_peak = torch.cuda.max_memory_allocated(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
        first = len(self.outputs)
        ms = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            ms.append(self.tick())
        elapsed = time.perf_counter() - t0
        bad = sum(not (torch.isfinite(v).all() and torch.isfinite(a).all())
                  for v, a in self.outputs[first:])
        self.window_ms = ms
        return dict(seconds=elapsed, ticks=len(ms), ms=ms, nonfinite=int(bad),
                    setup_peak_bytes=setup_peak, first=first,
                    flops=len(ms) * F.serve_tick_flops(
                        self.mc, self.tr["ring_frames"], self.tr["steps"]))

    def end_to_end(self, w):
        ms = w["ms"]
        p95 = statistics.quantiles(ms, n=100, method="inclusive")[94] \
            if len(ms) > 1 else ms[0]
        return {"serve_frames_per_s": (self.B * w["ticks"] / w["seconds"],
                                       "frames/s"),
                "tick_ms_p95": (p95, "ms")}

    def answers(self, w):
        return w["ticks"], w["nonfinite"]

    # ------------------------------------------------------------- trace
    def traced(self):
        """``trace_ticks`` more ticks under the profiler. The profiler
        slows the graph's launch, so a traced tick lasts longer than a
        window's; both medians are logged, and no metric reads the
        traced slice's idle time."""
        from perfbench import trace
        n = self.wl["trace_ticks"]
        ms = []

        def run():
            for _ in range(n):
                with torch.profiler.record_function("bench.tick"):
                    ms.append(self.tick())

        tr = trace.capture(run)
        print(f"[perfbench] tick ms, median: traced {statistics.median(ms)}"
              f", window {statistics.median(self.window_ms)}",
              file=sys.stderr, flush=True)
        return dict(trace=tr, ticks=n,
                    flops=n * F.serve_tick_flops(self.mc,
                                                 self.tr["ring_frames"],
                                                 self.tr["steps"]))

    # -------------------------------------------------------- correctness
    def free(self):
        self.pipe = None

    def reference(self, precision="fp32"):
        """The reference's answers to the first ``ref_ticks`` ticks the
        program ran (all of them where it ran fewer), from the same
        inputs."""
        from perfbench.reference.serve import ServeReference
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from perfbench.reference.model import param_spec
        tr = self.tr
        n = min(len(self.outputs), self.wl["ref_ticks"])
        # the weights as served: bfloat16 values
        w = {k: v.float() for k, v in make_weights(
            param_spec(self.mc), self.run.seed, torch.bfloat16,
            self.dev).items()}
        ref = ServeReference(self.mc, w, tr["ring_frames"], tr["noise_prev"],
                             tr["prime_frames"] + n + 2, precision, self.dev)
        c = self.ctx
        ref.prime(c["lat"], c["aud"], c["mouse"], c["btn"], c["z_lat"],
                  c["z_aud"])
        out = []
        for i in range(n):
            mouse, btn, init, renoise = self.tick_inputs(i)
            m = torch.from_numpy(mouse).to(self.dev)[None, None]
            b = torch.from_numpy(btn).to(self.dev)[None, None]
            out.append(ref.tick(m, b, init, renoise))
        return out

    def compare(self, ref):
        """The worst compared tick's relative L2 error of the video and
        of the audio latent against the reference."""
        worst_v = worst_a = 0.0
        errs = []
        for (pv, pa), (rv, ra) in zip(self.outputs, ref):
            ev = float((pv.to(rv.device).float() - rv).norm() / rv.norm())
            ea = float((pa.to(ra.device).float() - ra).norm() / ra.norm())
            errs.append(max(ev, ea))
            worst_v, worst_a = max(worst_v, ev), max(worst_a, ea)
        out = {"video_err": worst_v, "audio_err": worst_a}
        if not all(np.isfinite(v) for v in out.values()):
            out = {k: float("inf") for k in out}
        return out, {"ticks_compared": len(errs),
                     "median_tick_err": statistics.median(errs)}
