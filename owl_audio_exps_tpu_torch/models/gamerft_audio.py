"""Joint video + audio rectified-flow world model (counterpart of
owl_audio_exps_tpu/models/gamerft_audio.py ``GameRFTAudioCore`` and
``GameRFTAudio``).

The backbone is ``config.backbone``: the DiT or the UViT (nn/attn.py)
over one stream [b, n * (h*w + 1), d] in which, per frame, 64 video
tokens and 1 audio token are interleaved, or the dual-stream MMDiT
(nn/mmattn.py), which interleaves them for attention only. The per-frame
cond is the timestep embedding plus, unless ``uncond``, the control embedding. The training
wrapper noises video and audio with one per-frame timestep and returns
(video MSE + audio MSE, video MSE, audio MSE), all f32. The noise comes
from a ``torch.Generator``, which gives other numbers than the JAX
package's keys from the same seed: ``GameRFTAudio.forward`` therefore also
takes the draws (``ts``, ``z_video``, ``z_audio``, ``has_controls``) from
the caller, as the tests do with the JAX model's own draw.

Context parallelism (``sequence_parallel`` on a mesh whose seq axis holds
n > 1 ranks), as models/gamerft.py runs it for the video model: the
wrapper draws at full size (every seq rank alike) and keeps this rank's
frames [s F / n, (s + 1) F / n) of the latents, draws and controls; the
core takes ``frame_offset`` and places each stream's tokens at their
global RoPE positions (frame f's V + 1 tokens at (f V + f) .. in the
per-frame interleave, which every backbone's attention runs on); the
attention of every backbone goes through parallel/context.py (the JAX
package shards any model's uncached attention over ``seq``,
owl_audio_exps_tpu/nn/attn.py:311-330, the MMDiT's through the same
function, nn/mmattn.py:80-82). The video and audio losses are this
rank's squared-error sums over the whole batch's element counts, so
summed over the seq axis they are the global means.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..nn.attn import DiT, UViT
from ..nn.embeddings import ControlEmbedding, TimestepEmbedding
from ..nn.layers import FinalLayer, Linear, reset_parameters
from ..ops.norms import layer_norm
from ..parallel.mesh import get_mesh, seq_parallel_active
from ..utils.device import resolve_device
from .gamerft import handle_cfg


class GameRFTAudioCore(nn.Module):
    """(video, audio, t, mouse, btn) -> (v_video, v_audio).

    ``device`` defaults to "cuda" and raises when no card is present;
    pass ``device="cpu"`` explicitly for CPU runs. Parameters are float32
    until the caller casts the module (``.to(torch.bfloat16)``); compute
    runs in ``dtype``. ``seed`` draws the initial weights from a
    ``torch.Generator`` on the device."""

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
                kv_cache=None, write: bool = False, decoding: bool = False,
                write_len: Optional[int] = None, frame_offset: int = 0):
        """x [b, n, c, h, w], audio [b, n, c_a], t [b, n] -> (v_video,
        v_audio). Under context parallelism x and audio hold this rank's
        frames, the first of them frame ``frame_offset``. With
        ``kv_cache`` the forward attends over the ring (updated in place)
        and, with ``write``, commits its leading ``write_len`` frames (all
        by default) to it: each frame's 64 video tokens and then its audio
        token, in stream order (the MMDiT commits every frame, see
        ``run_backbone``)."""
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

        def edge(layer, *args):
            return (checkpoint(layer, *args, use_reentrant=False) if remat
                    else layer(*args))

        vid = x.permute(0, 1, 3, 4, 2).reshape(b, n * h * w, c)
        vid = edge(self.proj_in, vid.to(self.dtype))
        aud = edge(self.audio_proj_in, audio.to(self.dtype))
        video, aud_out = run_backbone(self.transformer, vid, aud, cond,
                                      kv_cache, write, decoding, write_len,
                                      frame_offset)

        video = edge(self.proj_out, layer_norm(video), layer_norm(cond))
        video = video.reshape(b, n, h, w, c).permute(0, 1, 4, 2, 3)
        aud_out = edge(self.audio_proj_out, aud_out, cond)
        return video, aud_out


def backbone_cls(config):
    """The backbone class of ``config.backbone``: ``dit``, ``uvit`` or
    ``mmdit``."""
    backbone = config.get("backbone", "dit")
    if backbone == "dit":
        return DiT
    if backbone == "uvit":
        return UViT
    if backbone == "mmdit":
        from ..nn.mmattn import MMDiT
        return MMDiT
    raise ValueError(f"Invalid backbone: {backbone}")


def run_backbone(transformer, vid, aud, cond, kv_cache=None,
                 write: bool = False, decoding: bool = False,
                 write_len: Optional[int] = None, frame_offset: int = 0):
    """The AV backbone on video tokens [b, n V, d] and audio tokens [b, n,
    d] -> the same two streams. The DiT and the UViT run the per-frame
    interleave [V video tokens | 1 audio token] as one stream and commit
    the leading ``write_len`` frames (all by default); the MMDiT keeps the
    streams apart and, as the JAX package's, takes no ``write_len``: a
    write commits every frame of the forward. The interleave's first
    token is at position ``frame_offset`` (V + 1)."""
    from ..nn.mmattn import MMDiT
    b, n, d = aud.shape
    V = vid.shape[1] // n
    if isinstance(transformer, MMDiT):
        return transformer(vid, aud, cond, kv_cache, write=write,
                           decoding=decoding,
                           pos_offset=frame_offset * (V + 1))
    stream = torch.cat([vid.reshape(b, n, V, d), aud[:, :, None, :]], dim=2)
    stream = transformer(stream.reshape(b, n * (V + 1), d), cond, None,
                         kv_cache, pos_offset=frame_offset * (V + 1),
                         write=write, decoding=decoding,
                         write_len=None if write_len is None
                         else write_len * (V + 1))
    stream = stream.reshape(b, n, V + 1, d)
    return stream[:, :, :-1].reshape(b, n * V, d), stream[:, :, -1]


class GameRFTAudio(nn.Module):
    """Training wrapper: one per-frame timestep noises video and audio."""

    def __init__(self, config, dtype=torch.bfloat16, device="cuda",
                 seed: Optional[int] = 0):
        super().__init__()
        self.config = config
        self.core = GameRFTAudioCore(config, dtype=dtype, device=device,
                                     seed=seed)

    def forward(self, x, audio, mouse=None, btn=None, has_controls=None,
                generator: Optional[torch.Generator] = None, ts=None,
                z_video=None, z_audio=None, return_dict: bool = False,
                cfg_prob: Optional[float] = None):
        """x: [b, n, c, h, w] and audio [b, n, c_a] latents -> (loss,
        video_loss, audio_loss), f32, or with ``return_dict`` the JAX
        package's dict of the losses, the noised inputs, the predictions,
        the draws and the CFG mask. The draws come from ``generator`` in
        the JAX package's order (cfg dropout at ``cfg_prob``, by default
        the config's, timesteps, video noise, audio noise) unless ``ts``
        [b, n], ``z_video`` (x's shape) and ``z_audio`` (audio's shape) are
        given; a caller that hands them in also hands in the post-dropout
        ``has_controls`` (the dropout is then not applied). Under context
        parallelism the losses are this rank's shares and the dict's
        tensors this rank's frames (see the module docstring)."""
        b, n = x.shape[0], x.shape[1]
        dev = x.device
        if has_controls is None:
            has_controls = torch.ones(b, dtype=torch.bool, device=dev)
        if ts is None:
            has_controls = handle_cfg(
                generator, has_controls,
                self.config.cfg_prob if cfg_prob is None else cfg_prob)
            ts = torch.sigmoid(torch.randn(b, n, generator=generator,
                                           device=dev))
            z_video = torch.randn(x.shape, generator=generator, device=dev)
            z_audio = torch.randn(audio.shape, generator=generator,
                                  device=dev)
        count_v, count_a = x.numel(), audio.numel()
        sp, f0 = seq_parallel_active(self.config), 0
        if sp:
            f0, f1 = get_mesh().seq_frames(n)
            x, audio, ts, z_video, z_audio = (
                a[:, f0:f1] for a in (x, audio, ts, z_video, z_audio))
            mouse, btn = (None if a is None else a[:, f0:f1]
                          for a in (mouse, btn))
        ts = ts.float()
        xf, af = x.float(), audio.float()
        z_video, z_audio = z_video.float(), z_audio.float()
        te_v = ts[:, :, None, None, None]
        lerpd_v = xf * (1.0 - te_v) + z_video * te_v
        te_a = ts[:, :, None]
        lerpd_a = af * (1.0 - te_a) + z_audio * te_a

        pred_v, pred_a = self.core(lerpd_v.to(x.dtype), lerpd_a.to(audio.dtype),
                                   ts.to(x.dtype), mouse, btn, has_controls,
                                   frame_offset=f0)
        sq_v = torch.square(pred_v.float() - (z_video - xf))
        sq_a = torch.square(pred_a.float() - (z_audio - af))
        if sp:   # this rank's share of the global means
            video_loss, audio_loss = sq_v.sum() / count_v, sq_a.sum() / count_a
        else:
            video_loss, audio_loss = torch.mean(sq_v), torch.mean(sq_a)
        loss = video_loss + audio_loss
        if not return_dict:
            return loss, video_loss, audio_loss
        return {"diffusion_loss": loss, "video_loss": video_loss,
                "audio_loss": audio_loss, "lerpd_video": lerpd_v,
                "lerpd_audio": lerpd_a, "pred_video": pred_v,
                "pred_audio": pred_a, "ts": ts, "z_video": z_video,
                "z_audio": z_audio, "cfg_mask": has_controls}
