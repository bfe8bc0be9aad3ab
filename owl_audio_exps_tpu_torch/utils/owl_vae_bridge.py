"""VAE bridge: encoders and decoders between pixels or waveforms and
latents (counterpart of owl_audio_exps_tpu/utils/owl_vae_bridge.py).

The audio VAE is the port's own (nn/audio_vae.py); the video decoder is
the DC-AE decoder (nn/dcae.py, ``vae_id`` "dcae", reading a diffusers
``AutoencoderDC`` or bare decoder state_dict), with a small pixel-shuffle
decoder for ``vae_id`` null. Every decoder and encoder runs in bf16 on
its device (the card by default): convolution weights are stored in
bf16, norms in float32. The batched helpers micro-batch as the JAX
package does:

* ``make_batched_decode_fn``: video [b, n, c, h, w] flattened to
  [b * n, ...] and decoded ``batch_size`` frames at a time;
* ``make_batched_audio_decode_fn``: audio latents in windows of
  ``max_seq_len`` (120) latents, ``batch_size`` rows at a time;
* ``make_batched_audio_encode_fn``: the inverse, in windows of 120 x 735
  = 88,200 samples.

Weights come from a seed, or from ``ckpt_path``: the port's own
checkpoint file or export directory, or a torch state_dict of the module
(the audio VAE's encoder at ``ckpt_path + "_enc"``, its decoder at
``ckpt_path + "_dec"``, as the JAX package reads them). The JAX package
keeps these in orbax checkpoints, which cannot be read without JAX: such
a directory raises.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch

from ..nn import audio_vae, dcae
from ..nn.audio_vae import AudioDecoder, AudioEncoder
from .checkpoints import load_torch_file
from .device import resolve_device

SAMPLES_PER_LATENT = 735   # 44.1 kHz / 60 latents a second
BF16 = torch.bfloat16


def load_state_dict(path: str):
    """A state_dict from ``path``: a ``save_checkpoint`` file (its EMA,
    else its params), a ``save_clean_export`` directory, or a torch
    state_dict file (utils/checkpoints.py ``load_torch_file``). An orbax
    checkpoint directory raises."""
    if os.path.isdir(path) and not os.path.exists(
            os.path.join(path, "params.pt")):
        raise ValueError(
            f"{path} is a directory without params.pt: an orbax checkpoint "
            "of the JAX package cannot be read without JAX; export its "
            "params as a torch state_dict (utils/weights.py "
            "vae_params_from_jax maps them)")
    return load_torch_file(path)


def _init_or_load(module: torch.nn.Module, ckpt_path: Optional[str]):
    if ckpt_path:
        module.load_state_dict(load_state_dict(ckpt_path), strict=True)
    return module


class Apply:
    """A module run under no_grad on its device, inputs moved there;
    ``module`` stays reachable (to load or inspect its weights)."""

    def __init__(self, module: torch.nn.Module):
        self.module = module.eval()
        self.device = next(module.parameters()).device

    @torch.no_grad()
    def __call__(self, x):
        return self.module(torch.as_tensor(x).to(self.device))


def get_audio_encoder_decoder(cfg_path: Optional[str] = None,
                              ckpt_path: Optional[str] = None,
                              latent_channels: int = 64, device="cuda"):
    """(encode, decode): [b, T, 2] -> [b, T / 735, c] (bf16) and [b, n, c]
    -> [b, n * 735, 2] (float32). ``cfg_path`` is accepted and unread, as
    in the JAX package."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    enc = AudioEncoder(latent_channels=latent_channels, dtype=BF16,
                       device=device)
    dec = AudioDecoder(latent_channels=latent_channels, dtype=BF16,
                       device=device)
    pair = []
    for module, suffix in ((enc, "_enc"), (dec, "_dec")):
        audio_vae.reset_parameters(module, gen)
        _init_or_load(module, ckpt_path and ckpt_path + suffix)
        pair.append(Apply(audio_vae.cast_weights_(module, BF16)))
    return tuple(pair)


def check_latents(z, what: str):
    """Video decoders take a batch of frame latents [b, c, h, w] (where the
    JAX decoders' transpose fails on any other rank)."""
    if z.ndim != 4:
        raise ValueError(f"{what} takes latents [b, c, h, w], got shape "
                         f"{tuple(z.shape)}")


class PixelShuffleVideoDecoder(torch.nn.Module):
    """Latent [b, c, h, w] -> RGB [b, h * up, w * up, 3] float32 in
    [-1, 1]: conv3x3 to 256, SiLU, conv3x3 to 3 up^2, depth-to-space in
    the JAX decoder's (i, j, rgb) order, tanh; bf16 convolutions."""

    def __init__(self, latent_channels: int = 128, upscale: int = 8,
                 ckpt_path: Optional[str] = None, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.up = upscale
        kw = dict(dtype=BF16, device=device)
        self.conv1 = dcae.Conv2d(latent_channels, 256, 3, **kw)
        self.conv2 = dcae.Conv2d(256, 3 * upscale * upscale, 3, **kw)
        dcae.reset_parameters(self, torch.Generator(device=device)
                              .manual_seed(0))
        _init_or_load(self, ckpt_path)
        dcae.cast_weights_(self, BF16)
        self.eval()

    @torch.no_grad()
    def forward(self, z_bchw):
        check_latents(z_bchw, "PixelShuffleVideoDecoder")
        z = z_bchw.to(BF16).contiguous(memory_format=dcae.CL)
        h = dcae.nhwc(self.conv2(torch.nn.functional.silu(self.conv1(z))))
        b, hh, ww, _ = h.shape
        up = self.up
        h = h.reshape(b, hh, ww, up, up, 3).permute(0, 1, 3, 2, 4, 5)
        return torch.tanh(h.reshape(b, hh * up, ww * up, 3).float())


class DCAEVideoDecoder:
    """The DC-AE decoder in bf16 (``module``); ``ckpt_path`` a torch
    state_dict of a full ``AutoencoderDC`` (keys under ``decoder.``) or of
    the bare decoder, else seeded weights."""

    def __init__(self, latent_channels: int = 128,
                 ckpt_path: Optional[str] = None, device="cuda", **dec_kw):
        self.module = dcae.DCAEDecoder(latent_channels=latent_channels,
                                       dtype=BF16, device=device, **dec_kw)
        if ckpt_path:
            self.module.load_state_dict(
                decoder_state_dict(load_state_dict(ckpt_path)), strict=True)
        dcae.cast_weights_(self.module, BF16).eval()

    @torch.no_grad()
    def __call__(self, z_bchw):
        """[b, c, h, w] latents -> [b, H, W, 3] float32 frames."""
        check_latents(z_bchw, "DCAEVideoDecoder")
        return dcae.nhwc(self.module(z_bchw)).float()


def decoder_state_dict(sd: dict) -> dict:
    """The decoder's state_dict of a full ``AutoencoderDC``'s (its
    ``decoder.`` keys, unprefixed) or of a bare decoder's (as it is)."""
    prefix = "decoder."
    if any(k.startswith(prefix) for k in sd):
        sd = {k[len(prefix):]: v for k, v in sd.items()
              if k.startswith(prefix)}
    return sd


def get_decoder_only(vae_id: Optional[str], cfg_path: Optional[str] = None,
                     ckpt_path: Optional[str] = None,
                     latent_channels: int = 128, device="cuda"):
    """The video frame decoder of ``vae_id`` ("dcae", else the
    pixel-shuffle decoder); ``cfg_path`` is accepted and unread, as in the
    JAX package."""
    if vae_id == "dcae":
        return DCAEVideoDecoder(latent_channels=latent_channels,
                                ckpt_path=ckpt_path, device=device)
    return PixelShuffleVideoDecoder(latent_channels=latent_channels,
                                    ckpt_path=ckpt_path, device=device)


def make_batched_decode_fn(decoder, batch_size: int = 4) -> Callable:
    """[b, n, c, h, w] latents -> [b, n, H, W, 3] frames, decoded
    ``batch_size`` frames at a time."""

    def decode(latents):
        b, n = latents.shape[0], latents.shape[1]
        flat = latents.reshape((b * n,) + tuple(latents.shape[2:]))
        out = torch.cat([decoder(flat[i:i + batch_size])
                         for i in range(0, flat.shape[0], batch_size)])
        return out.reshape((b, n) + tuple(out.shape[1:]))

    return decode


def make_batched_audio_decode_fn(decode, batch_size: int = 4,
                                 max_seq_len: int = 120) -> Callable:
    """[b, n, c] latents -> [b, n * 735, 2] waveforms, ``max_seq_len``
    latents and ``batch_size`` rows at a time."""

    def fn(latents):
        b, n = latents.shape[0], latents.shape[1]
        return torch.cat([
            torch.cat([decode(latents[i:i + batch_size, s:s + max_seq_len])
                       for i in range(0, b, batch_size)])
            for s in range(0, n, max_seq_len)], dim=1)

    return fn


def make_batched_audio_encode_fn(
        encode, batch_size: int = 4,
        max_samples: int = 120 * SAMPLES_PER_LATENT) -> Callable:
    """[b, T, 2] waveforms -> [b, T / 735, c] latents, ``max_samples``
    samples and ``batch_size`` rows at a time."""

    def fn(wf):
        b, T = wf.shape[0], wf.shape[1]
        return torch.cat([
            torch.cat([encode(wf[i:i + batch_size, s:s + max_samples])
                       for i in range(0, b, batch_size)])
            for s in range(0, T, max_samples)], dim=1)

    return fn
