"""Video-only rectified-flow world model (counterpart of
owl_audio_exps_tpu/models/gamerft.py ``handle_cfg``, ``GameRFTCore`` and
``GameRFT``).

Token layout ``b (n h w) c``; per-frame timesteps drawn sigmoid-normal;
velocity target z - x; f32 MSE; exact-fraction CFG dropout. The noise
comes from a ``torch.Generator``, which gives other numbers than the JAX
package's keys from the same seed: ``GameRFT.forward`` therefore also
takes the draws (``ts``, ``z``, ``has_controls``) from the caller, as the
tests do with the JAX model's own draw.

Context parallelism (``sequence_parallel`` on a mesh whose seq axis holds
n > 1 ranks, parallel/mesh.py): ``GameRFT`` takes the whole batch on
every seq rank, draws the CFG dropout, the timesteps and the noise at
full size from the generator (which every seq rank seeds alike, so all
draw the same), then keeps this rank's frames [s * F / n, (s + 1) * F / n)
of the latents, draws and controls. ``GameRFTCore`` embeds them with
RoPE at their global positions (``frame_offset``), and the loss is this
rank's share of the global mean: its squared-error sum over the element
count of the whole batch. Summing the ranks' losses (and gradients) over
the seq axis gives the non-parallel step's.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..nn.attn import DiT
from ..nn.embeddings import ControlEmbedding, TimestepEmbedding
from ..nn.layers import FinalLayer, Linear, reset_parameters
from ..parallel.mesh import get_mesh, seq_parallel_active
from ..utils.device import resolve_device


def handle_cfg(generator: Optional[torch.Generator], has_controls,
               cfg_prob: float, u: Optional[torch.Tensor] = None):
    """Exact-fraction CFG dropout: drop just enough conditioned rows to
    make the uncond fraction reach cfg_prob. ``u`` [b] are the uniform
    draws (from ``generator`` when not given)."""
    if cfg_prob <= 0.0 or has_controls is None:
        return has_controls
    hc = has_controls.float()
    pct_without = 1.0 - hc.mean()
    needed = cfg_prob - pct_without
    needed_frac = needed / hc.mean().clamp(min=1e-8)
    if u is None:
        u = torch.rand(has_controls.shape[0], generator=generator,
                       device=has_controls.device)
    drop = (u <= needed_frac) & has_controls
    dropped = has_controls & ~drop
    # only apply when we actually need more negatives
    return torch.where(pct_without < cfg_prob, dropped, has_controls)


class GameRFTCore(nn.Module):
    """Denoiser: (x, t, mouse, btn) -> velocity.

    ``device`` defaults to "cuda" and raises when no card is present;
    pass ``device="cpu"`` explicitly for CPU runs. Parameters are float32
    (the trainer's master weights) until the caller casts the module;
    compute runs in ``dtype``. ``seed`` draws the initial weights from a
    ``torch.Generator`` on the device."""

    def __init__(self, config, dtype=torch.bfloat16, device="cuda",
                 seed: Optional[int] = 0):
        super().__init__()
        device = resolve_device(device)
        backbone = config.get("backbone", "dit")
        if backbone != "dit":
            raise NotImplementedError(
                f"backbone {backbone!r}: the video model takes the 'dit' "
                "backbone only, as the JAX package's asserts "
                "(owl_audio_exps_tpu/models/gamerft.py:56); uvit and mmdit "
                "run in the AV model (models/gamerft_audio.py)")
        if config.tokens_per_frame != config.sample_size ** 2:
            raise ValueError("tokens_per_frame must be sample_size ** 2")
        self.config = config
        self.dtype = dtype
        d = config.d_model
        kw = dict(dtype=dtype, device=device)
        self.t_embed = TimestepEmbedding(d, **kw)
        if not config.uncond:
            self.control_embed = ControlEmbedding(config.n_buttons, d, **kw)
        self.proj_in = Linear(config.channels, d, bias=False, **kw)
        self.transformer = DiT(config, **kw)
        self.proj_out = FinalLayer(d, config.channels, **kw)
        if seed is not None:
            gen = torch.Generator(device=device).manual_seed(seed)
            reset_parameters(self, gen)

    def forward(self, x, t, mouse=None, btn=None, doc_id=None,
                has_controls=None, kv_cache=None, frame_offset: int = 0,
                write: bool = False, decoding: bool = False,
                write_len: Optional[int] = None):
        """x [b, n, c, h, w], t [b, n] -> velocity of x's shape. Under
        context parallelism x holds this rank's frames, the first of them
        frame ``frame_offset`` of the sequence. With ``kv_cache`` the
        forward attends over the ring (updated in place) and, with
        ``write``, commits its leading ``write_len`` frames (all by
        default) to it (nn/attn.py ``DiT``)."""
        cfg = self.config
        b, n, c, h, w = x.shape
        cond = self.t_embed(t)
        if not cfg.uncond:
            ctrl = self.control_embed(mouse, btn)
            if has_controls is not None:
                ctrl = torch.where(has_controls[:, None, None], ctrl,
                                   torch.zeros_like(ctrl))
            cond = cond + ctrl

        # the edge projections recompute in the backward under gradient
        # checkpointing, as in the JAX package
        remat = (cfg.get("gradient_checkpointing", False)
                 and kv_cache is None and torch.is_grad_enabled())
        tokens = x.permute(0, 1, 3, 4, 2).reshape(b, n * h * w, c)
        tokens = tokens.to(self.dtype)
        tokens = (checkpoint(self.proj_in, tokens, use_reentrant=False)
                  if remat else self.proj_in(tokens))
        tokens = self.transformer(
            tokens, cond, doc_id, kv_cache, pos_offset=frame_offset * h * w,
            write=write, decoding=decoding,
            write_len=None if write_len is None else write_len * h * w)
        tokens = (checkpoint(self.proj_out, tokens, cond, use_reentrant=False)
                  if remat else self.proj_out(tokens, cond))
        return tokens.reshape(b, n, h, w, c).permute(0, 1, 4, 2, 3)


class GameRFT(nn.Module):
    """Training wrapper: noising + loss around ``core``."""

    def __init__(self, config, dtype=torch.bfloat16, device="cuda",
                 seed: Optional[int] = 0):
        super().__init__()
        self.config = config
        self.core = GameRFTCore(config, dtype=dtype, device=device, seed=seed)

    def forward(self, x, mouse=None, btn=None, doc_id=None,
                has_controls=None, generator: Optional[torch.Generator] = None,
                ts=None, z=None, return_dict: bool = False,
                cfg_prob: Optional[float] = None):
        """x: [b, n, c, h, w] latents -> the f32 MSE loss (under context
        parallelism, this rank's share of it; see the module docstring),
        or with ``return_dict`` the JAX package's dict of the loss, the
        noised input, the prediction, the draws and the CFG mask (this
        rank's frames under context parallelism). The draws come from
        ``generator`` in the JAX package's order (cfg dropout at
        ``cfg_prob``, by default the config's, timesteps, noise) unless
        ``ts`` [b, n] and ``z`` (x's shape) are given; a caller that hands
        them in also hands in the post-dropout ``has_controls`` (the
        dropout is then not applied)."""
        b, n = x.shape[0], x.shape[1]
        dev = x.device
        if has_controls is None:
            has_controls = torch.ones(b, dtype=torch.bool, device=dev)
        if mouse is None or btn is None:
            has_controls = torch.zeros_like(has_controls)
            mouse = torch.zeros(b, n, self.config.get("n_mouse_axes", 2),
                                dtype=x.dtype, device=dev)
            btn = torch.zeros(b, n, self.config.n_buttons, dtype=x.dtype,
                              device=dev)
        if ts is None:
            has_controls = handle_cfg(
                generator, has_controls,
                self.config.cfg_prob if cfg_prob is None else cfg_prob)
            ts = torch.sigmoid(torch.randn(b, n, generator=generator,
                                           device=dev))
            z = torch.randn(x.shape, generator=generator, device=dev)
        count = x.numel()
        f0 = 0
        if seq_parallel_active(self.config):
            f0, f1 = get_mesh().seq_frames(n)
            x, ts, z, mouse, btn = (a[:, f0:f1] for a in
                                    (x, ts, z, mouse, btn))
        ts, z = ts.float(), z.float()
        xf = x.float()
        te = ts[:, :, None, None, None]
        lerpd = xf * (1.0 - te) + z * te
        target = z - xf

        pred = self.core(lerpd.to(x.dtype), ts.to(x.dtype), mouse, btn,
                         doc_id, has_controls, frame_offset=f0)
        loss = torch.sum(torch.square(pred.float() - target)) / count
        if not return_dict:
            return loss
        return {"diffusion_loss": loss, "video_loss": loss,
                "lerpd_video": lerpd, "pred_video": pred, "ts": ts,
                "z_video": z, "cfg_mask": has_controls}
