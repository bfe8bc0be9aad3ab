"""Joint video + audio rectified-flow denoiser (counterpart of
owl_audio_exps_tpu/models/gamerft_audio.py ``GameRFTAudioCore``).

Per frame, 64 video tokens and 1 audio token are interleaved into one
stream [b, n * (h*w + 1), d]; the per-frame cond is the timestep
embedding plus, unless ``uncond``, the control embedding.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.attn import DiT
from ..nn.embeddings import ControlEmbedding, TimestepEmbedding
from ..nn.layers import FinalLayer, Linear, reset_parameters
from ..ops.norms import layer_norm
from ..utils.device import resolve_device


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
        backbone = config.get("backbone", "dit")
        if backbone != "dit":
            raise NotImplementedError(
                f"backbone {backbone!r}: only 'dit' is ported (uvit and "
                "mmdit wait for a later slice)")
        self.config = config
        self.dtype = dtype
        d = config.d_model
        kw = dict(dtype=dtype, device=device)
        self.t_embed = TimestepEmbedding(d, **kw)
        if not config.uncond:
            self.control_embed = ControlEmbedding(config.n_buttons, d, **kw)
        self.proj_in = Linear(config.channels, d, bias=False, **kw)
        self.audio_proj_in = Linear(config.audio_channels, d, bias=False, **kw)
        self.transformer = DiT(config, **kw)
        self.proj_out = FinalLayer(d, config.channels, **kw)
        self.audio_proj_out = FinalLayer(d, config.audio_channels, **kw)
        if seed is not None:
            gen = torch.Generator(device=device).manual_seed(seed)
            reset_parameters(self, gen)

    def forward(self, x, audio, t, mouse=None, btn=None, has_controls=None,
                kv_cache=None):
        cfg = self.config
        b, n, c, h, w = x.shape
        cond = self.t_embed(t)
        if not cfg.uncond:
            ctrl = self.control_embed(mouse, btn)
            if has_controls is not None:
                ctrl = torch.where(has_controls[:, None, None], ctrl,
                                   torch.zeros_like(ctrl))
            cond = cond + ctrl

        vid = x.permute(0, 1, 3, 4, 2).reshape(b, n * h * w, c)
        vid = self.proj_in(vid.to(self.dtype))
        aud = self.audio_proj_in(audio.to(self.dtype))

        stream = torch.cat([vid.reshape(b, n, h * w, cfg.d_model),
                            aud[:, :, None, :]], dim=2)
        stream = stream.reshape(b, n * (h * w + 1), cfg.d_model)
        stream = self.transformer(stream, cond, None, kv_cache)
        stream = stream.reshape(b, n, h * w + 1, cfg.d_model)
        video = stream[:, :, :-1].reshape(b, n * h * w, cfg.d_model)
        aud_out = stream[:, :, -1]

        video = self.proj_out(layer_norm(video), layer_norm(cond))
        video = video.reshape(b, n, h, w, c).permute(0, 1, 4, 2, 3)
        aud_out = self.audio_proj_out(aud_out, cond)
        return video, aud_out
