"""The serve driver for several players: perfbench/drivers/serve.py's
closed loop with ``sessions`` sessions ticking in lockstep on one ring,
one batch row each (``AVCachedStreamingPipeline(n_sessions=...)``, the
steady tick replayed from its CUDA graph).

Set-up primes each session with a context clip of its own (one draw of
[sessions, T, ...] from the seed) and runs ``warm_ticks`` ticks. Each
tick draws each session's controls (mouse N(0,1) on 2 axes as bfloat16
values, buttons Bernoulli 0.5) and float32 noise from the sub-seed of
(tick, session), hands the pipeline [sessions, ...] inputs and ends when
every session's frame and audio latent are on the host. A tick counts
``sessions`` frames in ``serve_frames_per_s`` and ``sessions`` ticks'
model FLOPs in ``mfu.serve``.

The reference follows the first and the last session (rows 0 and
``sessions - 1``, so that a fault in the batch index shows), each
through reference/serve.py's one-session ``ServeReference`` over the
first ``ref_ticks`` ticks, from the same context and draws; the numbers
compared are the worst of those sessions' ticks.
"""

from __future__ import annotations

import copy
import statistics

import numpy as np
import torch

from perfbench.drivers.serve import Driver as ServeDriver
from perfbench.drivers.serve import bf_round, tick_seed
from perfbench.weights import load_into, make_weights, sub_seed


def session_seed(seed, i, s) -> int:
    """Session ``s``'s sub-seed of tick ``i`` of ``seed``."""
    return (tick_seed(seed, i) * 1_000_003 + int(s)) % (2 ** 63 - 1)


class Driver(ServeDriver):

    def __init__(self, run):
        self.run = run
        self.cfg = copy.deepcopy(run.config)
        self.mc = self.cfg["model"]
        self.wl = run.workload
        self.tr = self.wl["traffic"]
        self.dev = run.device
        self.B = self.tr["sessions"]
        self.followed = sorted({0, self.B - 1})

    # ------------------------------------------------------------ inputs
    def inputs(self):
        """Each session's context clip and its draws, [sessions, T, ...],
        from the seed; controls as bfloat16 values."""
        mc, tr, dev, B = self.mc, self.tr, self.dev, self.B
        p, T = mc["sample_size"], tr["prime_frames"]
        g = torch.Generator(device=dev).manual_seed(sub_seed(self.run.seed,
                                                             "data"))
        return dict(lat=torch.randn(B, T, mc["channels"], p, p, generator=g,
                                    device=dev),
                    aud=torch.randn(B, T, mc["audio_channels"], generator=g,
                                    device=dev),
                    mouse=bf_round(torch.randn(B, T, 2, generator=g,
                                               device=dev)),
                    btn=(torch.rand(B, T, mc["n_buttons"], generator=g,
                                    device=dev) > 0.5).float(),
                    z_lat=torch.randn(B, T, mc["channels"], p, p,
                                      generator=g, device=dev),
                    z_aud=torch.randn(B, T, mc["audio_channels"],
                                      generator=g, device=dev))

    def session_inputs(self, i, s):
        """Session ``s``'s inputs of tick ``i``: mouse [2], buttons
        [n_buttons] (numpy), the initial and re-noise draws (video [1, 1,
        c, h, w], audio [1, 1, c_a])."""
        mc, dev = self.mc, self.dev
        p = mc["sample_size"]
        seed = session_seed(self.run.seed, i, s)
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

    def tick_inputs(self, i):
        """Tick ``i``'s inputs of every session, stacked: mouse [sessions,
        2], buttons [sessions, n_buttons], the draws [sessions, 1, ...]."""
        per = [self.session_inputs(i, s) for s in range(self.B)]
        mouse = np.stack([m for m, _, _, _ in per])
        btn = np.stack([b for _, b, _, _ in per])
        init, renoise = (tuple(torch.cat([x[k][j] for x in per])
                               for j in range(2)) for k in (2, 3))
        return mouse, btn, init, renoise

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
            seed=0, n_sessions=self.B, fused_write=True, device=self.dev,
            graphed=self.dev.type == "cuda")
        c = self.ctx
        self.pipe.prime(c["lat"], c["aud"], c["mouse"], c["btn"],
                        noise=(c["z_lat"], c["z_aud"]))
        self.outputs = []
        for _ in range(tr["warm_ticks"]):
            self.tick()

    # ---------------------------------------------------- window, trace
    def window(self, seconds):
        w = super().window(seconds)
        w["flops"] *= self.B
        return w

    def traced(self):
        t = super().traced()
        t["flops"] *= self.B
        return t

    # -------------------------------------------------------- correctness
    def reference(self, precision="fp32"):
        """The reference's answers of the followed sessions to the first
        ``ref_ticks`` ticks the program ran (all of them where it ran
        fewer): per tick (video [followed, c, h, w], audio [followed,
        c_a])."""
        from perfbench.reference.model import param_spec
        from perfbench.reference.serve import ServeReference
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        tr, c = self.tr, self.ctx
        n = min(len(self.outputs), self.wl["ref_ticks"])
        # the weights as served: bfloat16 values
        w = {k: v.float() for k, v in make_weights(
            param_spec(self.mc), self.run.seed, torch.bfloat16,
            self.dev).items()}
        per = []
        for s in self.followed:
            ref = ServeReference(self.mc, w, tr["ring_frames"],
                                 tr["noise_prev"],
                                 tr["prime_frames"] + n + 2, precision,
                                 self.dev)
            ref.prime(*(c[k][s:s + 1] for k in ("lat", "aud", "mouse", "btn",
                                                "z_lat", "z_aud")))
            out = []
            for i in range(n):
                mouse, btn, init, renoise = self.session_inputs(i, s)
                m = torch.from_numpy(mouse).to(self.dev)[None, None]
                b = torch.from_numpy(btn).to(self.dev)[None, None]
                out.append(ref.tick(m, b, init, renoise))
            per.append(out)
            del ref
        return [tuple(torch.cat([o[i][j] for o in per]) for j in range(2))
                for i in range(n)]

    def compare(self, ref):
        """The worst compared tick's relative L2 error of the video and of
        the audio latent against the reference, over the followed
        sessions (the program's rows of them; answers with as many rows
        as the reference's, as the control hands in, are taken whole)."""
        worst_v = worst_a = 0.0
        errs = []
        for (pv, pa), (rv, ra) in zip(self.outputs, ref):
            if pv.shape[0] != rv.shape[0]:
                pv, pa = pv[self.followed], pa[self.followed]
            for j in range(rv.shape[0]):
                ev = float((pv[j].to(rv.device).float() - rv[j]).norm()
                           / rv[j].norm())
                ea = float((pa[j].to(ra.device).float() - ra[j]).norm()
                           / ra[j].norm())
                errs.append(max(ev, ea))
                worst_v, worst_a = max(worst_v, ev), max(worst_a, ea)
        out = {"video_err": worst_v, "audio_err": worst_a}
        if not all(np.isfinite(v) for v in out.values()):
            out = {k: float("inf") for k in out}
        return out, {"ticks_compared": len(errs) // len(self.followed),
                     "sessions_compared": self.followed,
                     "median_tick_err": statistics.median(errs)}
