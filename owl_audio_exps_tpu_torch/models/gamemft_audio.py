"""MeanFlow one-step AV model (counterpart of
owl_audio_exps_tpu/models/gamemft_audio.py ``GameMFTAudioCore`` and
``GameMFTAudio``).

MeanFlow trains an average velocity u(x_t, r, t) over the interval
[r, t] with the identity

    u_target = v_tilde - (t - r) * du/dt

whose total derivative du/dt is one forward-mode product (a jvp) of the
core along (dx = tangent, dr = 0, dt = 1), over the whole batch: the
frames with r = t reduce to the instant velocity because t - r = 0 there.
The tangent is the CFG-corrected velocity (omega' 1.3, omega 1.0, kappa =
1 - omega / omega') on rows whose t mostly falls in [0.3, 0.8], and the
plain velocity z - x elsewhere. Timesteps are logit-normal (mu -0.4,
sigma 1) with 25% of frames forced to r = t.

The jvp is ``torch.func.jvp`` over a closure of the core: the loss
differentiates through its primal output u (the target is detached), and
the gradient to the parameters flows through that primal as through an
ordinary forward. Two things meet the jvp that JAX composes freely:

* group remat (``torch.utils.checkpoint``): its recompute in the
  backward does not see the forward-mode tensors of the jvp, so the
  backbones run their blocks without checkpointing inside a torch.func transform
  (nn/attn.py); remat changes no value.
* the frame-mask kernel (K1, ops/splash.py), which an uncached forward
  of at least 1024 tokens takes on the card. The port's kernels have no
  forward-mode rule, so under the jvp they raise
  (ops/_attn_launch.py ``refuse_transforms``), as JAX's jvp raises at the
  splash kernel's ``custom_vjp``; the port does not give K1 a rule the
  reference lacks. Below 1024 tokens both packages take dense attention.

The draws come from a ``torch.Generator`` in the JAX package's order (CFG
dropout, r = t mask, timestep pair, video noise, audio noise), or from
the caller (``ts``, ``rs``, ``z_video``, ``z_audio`` and the post-dropout
``has_controls``), as the tests hand in the JAX model's draws.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.embeddings import ControlEmbedding, TimestepEmbedding
from ..nn.layers import FinalLayer, Linear, reset_parameters
from ..parallel.mesh import get_mesh, seq_parallel_active
from ..utils.device import resolve_device
from .gamerft import handle_cfg
from .gamerft_audio import backbone_cls, run_backbone


class GameMFTAudioCore(nn.Module):
    """Average-velocity denoiser: (x, audio, t, mouse, btn, r) -> (u_video,
    u_audio). The stream layout of ``GameRFTAudioCore`` (64 video tokens
    and 1 audio token a frame); the cond adds the interval embedding
    ``r_embed(t - r)`` (r = 0 when not given).

    ``device`` defaults to "cuda" and raises when no card is present;
    pass ``device="cpu"`` explicitly for CPU runs. Parameters are float32
    until the caller casts the module; compute runs in ``dtype``. ``seed``
    draws the initial weights from a ``torch.Generator`` on the device."""

    def __init__(self, config, dtype=torch.bfloat16, device="cuda",
                 seed: Optional[int] = 0):
        super().__init__()
        device = resolve_device(device)
        backbone = backbone_cls(config)
        self.config = config
        self.dtype = dtype
        d = config.d_model
        kw = dict(dtype=dtype, device=device)
        self.t_embed = TimestepEmbedding(d, **kw)
        self.r_embed = TimestepEmbedding(d, **kw)
        if not config.uncond:
            self.control_embed = ControlEmbedding(config.n_buttons, d, **kw)
        self.proj_in = Linear(config.channels, d, bias=False, **kw)
        self.audio_proj_in = Linear(config.audio_channels, d, bias=False, **kw)
        self.transformer = backbone(config, **kw)
        self.proj_out = FinalLayer(d, config.channels, **kw)
        self.audio_proj_out = FinalLayer(d, config.audio_channels, **kw)
        if seed is not None:
            gen = torch.Generator(device=device).manual_seed(seed)
            reset_parameters(self, gen)

    def forward(self, x, audio, t, mouse=None, btn=None, has_controls=None,
                kv_cache=None, r=None, write: bool = False,
                decoding: bool = False, write_len: Optional[int] = None,
                frame_offset: int = 0):
        """x [b, n, c, h, w], audio [b, n, c_a], t and r [b, n] ->
        (u_video, u_audio). ``kv_cache``, ``write``, ``decoding``,
        ``write_len`` and ``frame_offset`` as in ``GameRFTAudioCore``."""
        cfg = self.config
        b, n, c, h, w = x.shape
        if r is None:
            r = torch.zeros_like(t)
        cond = self.t_embed(t) + self.r_embed(t - r)
        if not cfg.uncond:
            ctrl = self.control_embed(mouse, btn)
            if has_controls is not None:
                ctrl = torch.where(has_controls[:, None, None], ctrl,
                                   torch.zeros_like(ctrl))
            cond = cond + ctrl

        vid = x.permute(0, 1, 3, 4, 2).reshape(b, n * h * w, c)
        vid = self.proj_in(vid.to(self.dtype))
        aud = self.audio_proj_in(audio.to(self.dtype))
        video, aud_out = run_backbone(self.transformer, vid, aud, cond,
                                      kv_cache, write, decoding, write_len,
                                      frame_offset)
        video = self.proj_out(video, cond)
        video = video.reshape(b, n, h, w, c).permute(0, 1, 4, 2, 3)
        return video, self.audio_proj_out(aud_out, cond)


class GameMFTAudio(nn.Module):
    """MeanFlow training wrapper: (loss, video loss, audio loss), f32, the
    contract of ``GameRFTAudio``, so the AV trainers train it as they
    are."""

    # MeanFlow hyperparameters (reference: gamemft_audio.py:124-137)
    ts_mu, ts_sigma, ts_ratio = -0.4, 1.0, 0.25
    cfg_scale, cfg_scale_2 = 1.3, 1.0     # omega', omega
    cfg_in_lo, cfg_in_hi, cfg_in_proportion = 0.3, 0.8, 0.25

    def __init__(self, config, dtype=torch.bfloat16, device="cuda",
                 seed: Optional[int] = 0):
        super().__init__()
        self.config = config
        self.core = GameMFTAudioCore(config, dtype=dtype, device=device,
                                     seed=seed)

    def sample_timesteps(self, b: int, n: int,
                         generator: Optional[torch.Generator] = None,
                         device=None, u=None, pair=None):
        """(t, r) [b, n]: a logit-normal pair, r <= t, 25% of frames
        forced to r = t. ``u`` [b, n] (uniform) and ``pair`` [b, n, 2]
        (standard normal) are the draws, from ``generator`` when not
        given."""
        if u is None:
            u = torch.rand(b, n, generator=generator, device=device)
        if pair is None:
            pair = torch.randn(b, n, 2, generator=generator, device=device)
        both = torch.sigmoid(pair.float() * self.ts_sigma + self.ts_mu)
        t = torch.maximum(both[..., 0], both[..., 1])
        r = torch.minimum(both[..., 0], both[..., 1])
        return t, torch.where(u < self.ts_ratio, t, r)

    def forward(self, x, audio, mouse=None, btn=None, has_controls=None,
                generator: Optional[torch.Generator] = None, ts=None,
                rs=None, z_video=None, z_audio=None):
        """x: [b, n, c, h, w] and audio [b, n, c_a] latents -> (loss,
        video_loss, audio_loss). The draws come from ``generator`` unless
        ``ts``, ``rs`` [b, n], ``z_video`` and ``z_audio`` are given,
        with the post-dropout ``has_controls``."""
        b, n = x.shape[0], x.shape[1]
        dev = x.device
        if has_controls is None:
            has_controls = torch.ones(b, dtype=torch.bool, device=dev)
        if ts is None:
            cp = self.config.get("cfg_prob")
            has_controls = handle_cfg(generator, has_controls,
                                      0.1 if cp is None else cp)
            ts, rs = self.sample_timesteps(b, n, generator, dev)
            z_video = torch.randn(x.shape, generator=generator, device=dev)
            z_audio = torch.randn(audio.shape, generator=generator,
                                  device=dev)
        # rows with enough frames of t in [0.3, 0.8] take the CFG tangent
        # (over all the frames, before a seq rank keeps its own)
        in_window = (ts.float() >= self.cfg_in_lo) & \
            (ts.float() <= self.cfg_in_hi)
        cfg_rows = has_controls & (in_window.float().mean(1)
                                   >= self.cfg_in_proportion)
        f0 = 0
        if seq_parallel_active(self.config):
            f0, f1 = get_mesh().seq_frames(n)
            x, audio, ts, rs, z_video, z_audio = (
                a[:, f0:f1] for a in (x, audio, ts, rs, z_video, z_audio))
            mouse, btn = (None if a is None else a[:, f0:f1]
                          for a in (mouse, btn))
        ts, rs = ts.float(), rs.float()
        xf, af = x.float(), audio.float()
        z_video, z_audio = z_video.float(), z_audio.float()
        te_v, te_a = ts[:, :, None, None, None], ts[:, :, None]
        noisy_v = xf * (1.0 - te_v) + z_video * te_v
        noisy_a = af * (1.0 - te_a) + z_audio * te_a
        v_vid, v_aud = z_video - xf, z_audio - af

        def u_of(zv, za, r, t, hc):
            uv, ua = self.core(zv.to(x.dtype), za.to(audio.dtype),
                               t.to(x.dtype), mouse, btn, has_controls=hc,
                               r=r.to(x.dtype), frame_offset=f0)
            return uv.float(), ua.float()

        # the CFG-corrected tangent: instant velocities (r = t) with and
        # without controls, no gradient
        kappa = 1.0 - self.cfg_scale_2 / self.cfg_scale
        with torch.no_grad():
            ones = torch.ones(b, dtype=torch.bool, device=dev)
            uv_c, ua_c = u_of(noisy_v, noisy_a, ts, ts, ones)
            uv_u, ua_u = u_of(noisy_v, noisy_a, ts, ts, ~ones)
            rest = 1.0 - self.cfg_scale - kappa
            tangent_vid = torch.where(
                cfg_rows[:, None, None, None, None],
                self.cfg_scale * v_vid + kappa * uv_c + rest * uv_u, v_vid)
            tangent_aud = torch.where(
                cfg_rows[:, None, None],
                self.cfg_scale * v_aud + kappa * ua_c + rest * ua_u, v_aud)

        # one jvp over the whole batch along (dx = tangent, dr = 0, dt = 1)
        (u_vid, u_aud), (du_vid, du_aud) = torch.func.jvp(
            lambda zv, za, r, t: u_of(zv, za, r, t, has_controls),
            (noisy_v.detach(), noisy_a.detach(), rs, ts),
            (tangent_vid, tangent_aud, torch.zeros_like(rs),
             torch.ones_like(ts)))

        diff = ts - rs
        targ_vid = (tangent_vid - du_vid * diff[:, :, None, None, None]
                    ).detach()
        targ_aud = (tangent_aud - du_aud * diff[:, :, None]).detach()
        loss_vid = (u_vid - targ_vid).reshape(b, -1).square().sum(1).mean()
        loss_aud = (u_aud - targ_aud).reshape(b, -1).square().sum(1).mean()
        return loss_vid + loss_aud, loss_vid, loss_aud
