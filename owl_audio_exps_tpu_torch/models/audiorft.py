"""Unconditional audio rectified-flow model (counterpart of
owl_audio_exps_tpu/models/audiorft.py ``AudioRFTCore`` and ``AudioRFT``).

Latents [b, n, c], one token per latent (``tokens_per_frame`` 1),
timestep-only conditioning, 1D RoPE (``audio1d``). The Core is the pure
denoiser that the samplers call, with or without the ring KV cache
(nn/kv_cache.py, updated in place); the wrapper owns the noising and the
velocity MSE. The wrapper's noise comes from a ``torch.Generator``, which
gives other numbers than the JAX package's keys from the same seed:
``AudioRFT.forward`` therefore also takes the draws (``ts``, ``z``) from
the caller, as the tests do with the JAX model's own draws.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.attn import DiT
from ..nn.embeddings import TimestepEmbedding
from ..nn.layers import FinalLayer, Linear, reset_parameters
from ..utils.device import resolve_device


class AudioRFTCore(nn.Module):
    """(x [b, n, c], t [b, n]) -> velocity [b, n, c].

    ``device`` defaults to "cuda" and raises when no card is present;
    pass ``device="cpu"`` explicitly for CPU runs. Parameters are float32
    until the caller casts the module; compute runs in ``dtype``. ``seed``
    draws the initial weights from a ``torch.Generator`` on the device."""

    def __init__(self, config, dtype=torch.bfloat16, device="cuda",
                 seed: Optional[int] = 0):
        super().__init__()
        device = resolve_device(device)
        if config.get("backbone", "dit") != "dit":
            raise NotImplementedError("AudioRFTCore runs the 'dit' backbone")
        if config.tokens_per_frame != 1:
            raise ValueError("AudioRFTCore takes one token per latent "
                             "(tokens_per_frame: 1)")
        self.config = config
        self.dtype = dtype
        d = config.d_model
        kw = dict(dtype=dtype, device=device)
        self.t_embed = TimestepEmbedding(d, **kw)
        self.proj_in = Linear(config.channels, d, bias=False, **kw)
        self.transformer = DiT(config, **kw)
        self.proj_out = FinalLayer(d, config.channels, **kw)
        if seed is not None:
            gen = torch.Generator(device=device).manual_seed(seed)
            reset_parameters(self, gen)

    def forward(self, x, t, doc_id=None, kv_cache=None, write: bool = False,
                decoding: bool = False, write_len: Optional[int] = None):
        """With ``kv_cache`` the forward attends over the ring and, with
        ``write``, commits its leading ``write_len`` tokens (all by
        default) to it (nn/attn.py ``DiT``)."""
        cond = self.t_embed(t)
        h = self.proj_in(x.to(self.dtype))
        h = self.transformer(h, cond, doc_id, kv_cache, write=write,
                             decoding=decoding, write_len=write_len)
        return self.proj_out(h, cond)


class AudioRFT(nn.Module):
    """Training wrapper: per-latent sigmoid-normal timesteps, velocity
    MSE in float32."""

    def __init__(self, config, dtype=torch.bfloat16, device="cuda",
                 seed: Optional[int] = 0):
        super().__init__()
        self.config = config
        self.core = AudioRFTCore(config, dtype=dtype, device=device,
                                 seed=seed)

    def forward(self, x, doc_id=None,
                generator: Optional[torch.Generator] = None, ts=None, z=None):
        """x: [b, n, c] latents -> loss (f32). The draws come from
        ``generator`` in the JAX package's order (timesteps, then noise)
        unless ``ts`` [b, n] and ``z`` (x's shape) are given."""
        b, n, _ = x.shape
        if ts is None:
            ts = torch.sigmoid(torch.randn(b, n, generator=generator,
                                           device=x.device))
            z = torch.randn(x.shape, generator=generator, device=x.device)
        ts, z = ts.float(), z.float()
        xf = x.float()
        te = ts[:, :, None]
        lerpd = xf * (1.0 - te) + z * te
        pred = self.core(lerpd.to(x.dtype), ts.to(x.dtype), doc_id)
        return torch.mean(torch.square(pred.float() - (z - xf)))
