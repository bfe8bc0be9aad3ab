"""Self-Forcing distillation trainer, video (counterpart of
owl_audio_exps_tpu/trainers/self_forcing.py).

The DMD triple and losses of CausVid, but the rollout is a true
autoregressive generation through the ring KV cache (nn/kv_cache.py):
the clean context of W frames is written at t = 0 under no gradient;
then each of ``min_rollout_frames`` new frames starts from noise at t = 1
and takes ``end`` Euler steps, ``end`` drawn from 1..``rollout_steps``:
the first ``end - 1`` of dt = 1 / ``rollout_steps`` under no gradient,
the last a jump to x0 = x - t v that carries the gradient. The clean
frame is then re-encoded into the ring under no gradient, which evicts
the oldest frame. The rollout's window is the trailing W frames of
[context | generated], its controls the batch's extended by batch
permutations.

The JAX package unrolls all ``rollout_steps`` steps of every frame and
masks the inactive ones with ``lax.select``; the port runs only the
active ``end`` steps, which gives the same values and gradients. The
cached forwards that need a gradient take plain attention, as in the JAX
package (the decode kernel has no backward; those under no gradient may
take it on the card), so the rollout launches no training kernel of the
port; the ring is written in place only under no gradient, and every
graded read of it copies (the [ring | new] concat or the local window's
gather), so the backward never reads a slot a later write overwrote.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..nn.kv_cache import KVCache
from ..utils.controls import batch_permute_to_length, doublings_to_length
from .causvid import CausVidTrainer


class SelfForceDraws(NamedTuple):
    perms: torch.Tensor      # [doublings, b] int64 control permutations
    init: torch.Tensor       # [R, b, 1, c, h, w] float32 initial noise
    ends: Tuple[int, ...]    # per rollout frame, its Euler steps


class SelfForceTrainer(CausVidTrainer):

    def rollout_frames(self) -> int:
        return self.train_cfg.get("min_rollout_frames", 8)

    def rollout_draws(self, vid, mouse) -> SelfForceDraws:
        b, W = vid.shape[:2]
        R = self.rollout_frames()
        gen, dev = self.generator, vid.device
        factor = doublings_to_length(mouse.shape[1], W + R)
        perms = torch.stack([torch.randperm(b, generator=gen, device=dev)
                             for _ in range(factor)]) if factor else \
            torch.zeros(0, b, dtype=torch.long, device=dev)
        init = torch.randn((R, b, 1) + tuple(vid.shape[2:]), generator=gen,
                           device=dev)
        steps = self.train_cfg.get("rollout_steps", 1)
        # the number of forwards: alike on every rank (the fsdp ranks of a
        # sharded step gather each weight in every forward)
        ends = torch.randint(1, steps + 1, (R,),
                             generator=self.shared_generator, device=dev)
        return SelfForceDraws(perms, init, tuple(ends.tolist()))

    def get_rollouts(self, student, vid, mouse, btn, with_grad: bool,
                     draws: Optional[SelfForceDraws] = None):
        b, W = vid.shape[:2]
        R = self.rollout_frames()
        dt = 1.0 / self.train_cfg.get("rollout_steps", 1)
        if draws is None:
            draws = self.rollout_draws(vid, mouse)
        dev, dtype = vid.device, vid.dtype
        ext_mouse, ext_btn = batch_permute_to_length(mouse, btn, W + R,
                                                     perms=draws.perms)

        cache = KVCache.from_config(self.model_cfg, b, capacity_frames=W,
                                    dtype=dtype, device=dev)
        with torch.no_grad():
            student(vid, torch.zeros(b, W, dtype=dtype, device=dev), mouse,
                    btn, kv_cache=cache, write=True)

        graded = with_grad and torch.is_grad_enabled()
        frames = []
        for i in range(R):
            m1 = ext_mouse[:, W + i:W + i + 1]
            b1 = ext_btn[:, W + i:W + i + 1]
            x = draws.init[i].to(dtype)
            t = torch.ones(b, 1, dtype=dtype, device=dev)
            with torch.no_grad():
                for _ in range(draws.ends[i] - 1):
                    pred = student(x, t, m1, b1, kv_cache=cache,
                                   decoding=True)
                    x = (x.float() - dt * pred.float()).to(dtype)
                    t = (t.float() - dt).to(dtype)
            with torch.set_grad_enabled(graded):
                pred = student(x, t, m1, b1, kv_cache=cache, decoding=True)
                x = (x.float() - t.float()[..., None, None, None]
                     * pred.float()).to(dtype)
            with torch.no_grad():
                student(x, torch.zeros_like(t), m1, b1, kv_cache=cache,
                        write=True, decoding=True)
            frames.append(x[:, 0])

        full = torch.cat([vid.float(), torch.stack(frames, 1).float()], 1)
        window = full[:, -W:]
        gen_mask = torch.cat([torch.zeros(b, W, dtype=torch.bool, device=dev),
                              torch.ones(b, R, dtype=torch.bool, device=dev)],
                             1)[:, -W:]
        # the regression target is the window itself, detached (the
        # reference pairs nothing with it; its weight defaults to 0)
        return (window, gen_mask, ext_mouse[:, -W:], ext_btn[:, -W:],
                window.detach())
