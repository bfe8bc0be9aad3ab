"""Plain float32 reference of the cached audio-video game loop: a
session that keeps the keys and values of its last ``ring`` frames and,
each tick, denoises one (frame, audio latent) pair from noise with a
2-step Euler schedule [1.0, 0.5] against them (owl-audio-exps
``AVCachedStreamingPipeline`` with the fused write, written out plainly).

Per tick, with the previous tick's frame pending at ``noise_prev``:
1. the pending frame (its timestep ``noise_prev``, the previous tick's
   controls) runs over [ring | itself] and its keys and values enter the
   ring, which drops its oldest frame when full;
2. the new frame (this tick's controls) runs at t = 1.0 and at t = 0.5
   over [ring | itself]; each step x <- x - 0.5 v;
3. the result is the tick's answer; it pends, re-noised at
   ``noise_prev`` with the tick's draw, for the next tick.
``prime`` caches a context clip: all but its last frame in one causal
forward, the last frame pending. Global layers see every frame of the
ring, local layers the frames less than ``local_window`` frames back.
Keys are rotated at their frames' absolute positions with angles worked
out in float64 (attention under these tables depends on frame distance
only, so no rebase is needed). The model's inputs round to bfloat16
(latents, timesteps, controls), as the published loop keeps them.
"""

from __future__ import annotations

import numpy as np
import torch

from .model import Model, blocked_attention, frame_visibility, rope
from .rope import angles

DT = (0.5, 0.5)


def bf(x):
    return x.to(torch.bfloat16).float()


class ServeReference:
    def __init__(self, cfg, params, ring: int, noise_prev: float,
                 max_frames: int, precision: str = "fp32", device="cuda"):
        self.cfg, self.ring, self.a = cfg, ring, noise_prev
        self.m = Model(cfg, params, precision=precision)
        self.tpf = cfg["tokens_per_frame"]
        self.win = cfg.get("local_window")
        d, H = cfg["d_model"], cfg["n_heads"]
        shape = (cfg["n_layers"], 1, H, ring * self.tpf, d // H)
        self.K = torch.zeros(shape, device=device)
        self.V = torch.zeros(shape, device=device)
        self.slot_frame = [-1] * ring     # the frame in each slot
        ang = torch.from_numpy(np.ascontiguousarray(
            angles(cfg, max_frames, np.float64))).to(device)
        self.cos, self.sin = torch.cos(ang).float(), torch.sin(ang).float()
        self.device = device
        self.pending = None

    # ---------------------------------------------------------- forwards
    def _rot(self, x, f0, n):
        s = slice(f0 * self.tpf, (f0 + n) * self.tpf)
        return rope(x, self.cos[s], self.sin[s])

    def _commit(self, layer, frames, k, v):
        """Write ``frames`` (absolute indices) of rotated k, v [1, H,
        n * tpf, Dh] into the ring of ``layer``."""
        for j, f in enumerate(frames):
            s = f % self.ring
            dst = slice(s * self.tpf, (s + 1) * self.tpf)
            src = slice(j * self.tpf, (j + 1) * self.tpf)
            self.K[layer, :, :, dst] = k[:, :, src]
            self.V[layer, :, :, dst] = v[:, :, src]

    def _one_frame(self, f, x, aud, t, mouse, btn, commit: bool):
        """One frame (absolute index f) over [ring | itself]; with
        ``commit`` its keys and values enter the ring afterwards."""
        m, tpf = self.m, self.tpf
        win = self.win if self.win is not None else f + 1
        idx = {}
        for loc, w in ((False, f + 1), (True, win)):
            slots = [s for s, g in enumerate(self.slot_frame)
                     if 0 <= g < f and f - g < w]
            idx[loc] = None if len(slots) == self.ring else torch.tensor(
                [s * tpf + j for s in slots for j in range(tpf)],
                dtype=torch.long, device=self.device)
        written = []

        def ring_of(buf, loc):
            return buf if idx[loc] is None else buf.index_select(2, idx[loc])

        def attend(i, local, q, k, v):
            q, k = self._rot(q, f, 1), self._rot(k, f, 1)
            q, k, v = (m.prec.q(t_) for t_ in (q, k, v))
            kk = torch.cat([ring_of(self.K[i], local), k], 2)
            vv = torch.cat([ring_of(self.V[i], local), v], 2)
            s = torch.matmul(q, kk.transpose(-1, -2)) * q.shape[-1] ** -0.5
            o = torch.matmul(torch.softmax(s, -1), vv)
            if commit:
                written.append((i, k, v))
            return o

        out = m.av(bf(x), bf(aud), bf(t), bf(mouse), bf(btn), None, attend)
        for i, k, v in written:
            self._commit(i, [f], k, v)
        if commit:
            self.slot_frame[f % self.ring] = f
        return out

    @torch.no_grad()
    def prime(self, lat, aud, mouse, btn, z_lat, z_aud):
        """lat [1, T, c, h, w], aud [1, T, c_a], controls [1, T, .], the
        context's float32 draws: frames 0 .. T-2 enter the ring, frame
        T-1 pends."""
        a = self.a
        x = bf(lat * (1 - a) + z_lat * a)
        au = bf(aud * (1 - a) + z_aud * a)
        T = x.shape[1]
        n = T - 1
        if n > self.ring:
            raise ValueError("a context longer than the ring")
        t = torch.full((1, n), a, device=self.device)
        causal = bool(self.cfg.get("causal", True))
        vis = {loc: frame_visibility(n, self.win if loc else None, causal,
                                     device=self.device)
               for loc in (False, True)}
        m = self.m

        def attend(i, local, q, k, v):
            q, k = self._rot(q, 0, n), self._rot(k, 0, n)
            q, k, v = (m.prec.q(t_) for t_ in (q, k, v))
            self._commit(i, range(n), k, v)
            return blocked_attention(q, k, v, vis[local], self.tpf)

        m.av(x[:, :n], au[:, :n], bf(t), bf(mouse[:, :n]), bf(btn[:, :n]),
             None, attend)
        for g in range(n):
            self.slot_frame[g % self.ring] = g
        self.pending = (x[:, n:], au[:, n:], mouse[:, n:], btn[:, n:], n)

    @torch.no_grad()
    def tick(self, mouse, btn, z_init, z_ren):
        """One tick: controls [1, 1, .], the float32 draws (video, audio)
        of the initial noise and of the re-noise; returns the answer
        (video [1, c, h, w], audio [1, c_a])."""
        px, pa, pm, pb, fp = self.pending
        t_prev = torch.full((1, 1), self.a, device=self.device)
        self._one_frame(fp, px, pa, t_prev, pm, pb, commit=True)
        f = fp + 1
        x, au = bf(z_init[0]), bf(z_init[1])
        t = 1.0
        for d in DT:
            tt = torch.full((1, 1), t, device=self.device)
            vx, va = self._one_frame(f, x, au, tt, mouse, btn, commit=False)
            x, au = x - d * vx, au - d * va
            t -= d
        self.pending = (x * (1 - self.a) + z_ren[0] * self.a,
                        au * (1 - self.a) + z_ren[1] * self.a, mouse, btn, f)
        return x[:, 0], au[:, 0]
