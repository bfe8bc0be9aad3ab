"""1-D convolutional audio VAE (counterpart of
owl_audio_exps_tpu/nn/audio_vae.py ``ResBlock1D``, ``AudioEncoder``,
``AudioDecoder`` and ``AudioVAE``).

Stereo 44.1 kHz waveforms [b, T, 2] <-> latents [b, T / 735, 64]: the
encoder strides 3, 5, 7, 7 (735 = 3 * 5 * 7 * 7), the decoder mirrors them.
Module names are those of tests/audio_vae_torch_mirror.py (``stem``,
``res_i.norm1/conv1/norm2/conv2``, ``down_i``, ``up_i``, ``head_norm``,
``head``), so the torch layout that the JAX package's
``utils/torch_import.import_audio_vae`` reads is this module's own
``state_dict``.

Numerics follow flax: convolutions run in ``dtype`` (weights and inputs
cast to it), GroupNorm (eps 1e-6, flax's default) in float32, the final
``tanh`` in float32. Padding is flax's "SAME": a strided convolution pads
(total // 2) before the signal and the rest after it. Flax's
``ConvTranspose(padding="SAME")`` with ``transpose_kernel=False`` is not
torch's ``ConvTranspose1d``: it dilates the input by the stride, pads as
lax ``_conv_transpose_padding`` does and correlates with the kernel
un-flipped (``UpConv1d.dilated``). That form multiplies by zero in s - 1
of every s positions; ``UpConv1d.forward`` computes the same function with
``F.conv_transpose1d`` on the flipped kernel and crops to the same
alignment.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device

GROUPS, GN_EPS = 8, 1e-6


class SameConv1d(nn.Module):
    """flax ``nn.Conv(out_ch, (k,), strides=(s,), padding="SAME")`` on
    [b, C, T], weight [out, in, k]."""

    def __init__(self, in_ch: int, out_ch: int, k: int, s: int = 1,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.k, self.s, self.dtype = k, s, dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(out_ch, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.shape[-1]
        out = -(-t // self.s)
        total = max((out - 1) * self.s + self.k - t, 0)
        x = F.pad(x.to(self.dtype), (total // 2, total - total // 2))
        return F.conv1d(x, self.weight.to(self.dtype),
                        self.bias.to(self.dtype), stride=self.s)


class UpConv1d(nn.Module):
    """flax ``nn.ConvTranspose(out_ch, (2s,), strides=(s,),
    padding="SAME")`` (``transpose_kernel=False``) on [b, C, T] -> [b, C',
    T * s]; weight [out, in, 2s], flax's kernel [k, in, out] transposed."""

    def __init__(self, in_ch: int, out_ch: int, s: int,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.s, self.k, self.dtype = s, 2 * s, dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 2 * s,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(out_ch, device=device))

    def _pad_before(self) -> int:
        """lax ``_conv_transpose_padding``'s leading pad of the dilated
        input."""
        s, k = self.s, self.k
        pad_len = k + s - 2
        return k - 1 if s > k - 1 else math.ceil(pad_len / 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the correlation of the padded dilated input is the transposed
        # convolution with the kernel flipped, cropped by k - 1 - pad_a
        t = x.shape[-1]
        crop = self.k - 1 - self._pad_before()
        w = self.weight.to(self.dtype).flip(-1).transpose(0, 1)
        y = F.conv_transpose1d(x.to(self.dtype), w, self.bias.to(self.dtype),
                               stride=self.s)
        return y[..., crop:crop + t * self.s]

    def dilated(self, x: torch.Tensor) -> torch.Tensor:
        """The flax form as written: zero-dilate by s, pad, correlate."""
        s, k = self.s, self.k
        b, c, t = x.shape
        xd = x.new_zeros(b, c, (t - 1) * s + 1, dtype=self.dtype)
        xd[:, :, ::s] = x.to(self.dtype)
        pad_a = self._pad_before()
        xd = F.pad(xd, (pad_a, k + s - 2 - pad_a))
        return F.conv1d(xd, self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


def group_norm(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """flax GroupNorm(dtype=float32): float32 in, float32 out."""
    return F.group_norm(x.float(), norm.num_groups, norm.weight.float(),
                        norm.bias.float(), norm.eps)


class ResBlock1D(nn.Module):
    def __init__(self, ch: int, in_ch: Optional[int] = None,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        in_ch = in_ch or ch
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.norm1 = nn.GroupNorm(GROUPS, in_ch, eps=GN_EPS, device=device)
        self.conv1 = SameConv1d(in_ch, ch, 3, **kw)
        self.norm2 = nn.GroupNorm(GROUPS, ch, eps=GN_EPS, device=device)
        self.conv2 = SameConv1d(ch, ch, 3, **kw)
        self.skip = SameConv1d(in_ch, ch, 1, **kw) if in_ch != ch else None

    def forward(self, x):
        h = self.conv1(F.silu(group_norm(self.norm1, x)).to(self.dtype))
        h = self.conv2(F.silu(group_norm(self.norm2, h)).to(self.dtype))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class AudioEncoder(nn.Module):
    """[b, T, 2] -> [b, T / 735, latent_channels] in ``dtype``."""

    def __init__(self, latent_channels: int = 64, base_channels: int = 32,
                 strides: Sequence[int] = (3, 5, 7, 7),
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.stem = SameConv1d(2, base_channels, 7, **kw)
        ch = base_channels
        for i, s in enumerate(strides):
            setattr(self, f"res_{i}", ResBlock1D(ch, **kw))
            nxt = min(ch * 2, 256)
            setattr(self, f"down_{i}", SameConv1d(ch, nxt, 2 * s, s, **kw))
            ch = nxt
        self.n_stages = len(strides)
        self.dtype = dtype
        self.head_norm = nn.GroupNorm(GROUPS, ch, eps=GN_EPS, device=device)
        self.head = SameConv1d(ch, latent_channels, 3, **kw)

    def forward(self, x):
        h = self.stem(x.movedim(-1, 1))
        for i in range(self.n_stages):
            h = getattr(self, f"down_{i}")(getattr(self, f"res_{i}")(h))
        h = F.silu(group_norm(self.head_norm, h)).to(self.dtype)
        return self.head(h).movedim(1, -1)


class AudioDecoder(nn.Module):
    """[b, n, latent_channels] -> [b, n * 735, 2], float32 in [-1, 1]."""

    def __init__(self, latent_channels: int = 64, base_channels: int = 32,
                 strides: Sequence[int] = (7, 7, 5, 3),
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        n = len(strides)
        chs = [min(base_channels * 2 ** (n - i), 256) for i in range(n)]
        self.stem = SameConv1d(latent_channels, chs[0], 3, **kw)
        prev = chs[0]
        for i, s in enumerate(strides):
            ch = chs[i + 1] if i + 1 < n else base_channels
            setattr(self, f"up_{i}", UpConv1d(prev, ch, s, **kw))
            setattr(self, f"res_{i}", ResBlock1D(ch, **kw))
            prev = ch
        self.n_stages = n
        self.dtype = dtype
        self.head_norm = nn.GroupNorm(GROUPS, prev, eps=GN_EPS, device=device)
        self.head = SameConv1d(prev, 2, 7, **kw)

    def forward(self, z):
        h = self.stem(z.movedim(-1, 1))
        for i in range(self.n_stages):
            h = getattr(self, f"res_{i}")(getattr(self, f"up_{i}")(h))
        h = F.silu(group_norm(self.head_norm, h)).to(self.dtype)
        return torch.tanh(self.head(h).float()).movedim(1, -1)


class AudioVAE(nn.Module):
    """Deterministic encoder / decoder pair with the reference latent
    geometry. ``device`` defaults to "cuda" and raises without a card;
    ``seed`` draws the initial weights (None leaves them unset, as on the
    meta device)."""

    def __init__(self, latent_channels: int = 64, dtype=torch.bfloat16,
                 device="cuda", seed: Optional[int] = 0):
        super().__init__()
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device)
        self.encoder = AudioEncoder(latent_channels=latent_channels, **kw)
        self.decoder = AudioDecoder(latent_channels=latent_channels, **kw)
        if seed is not None:
            reset_parameters(self, torch.Generator(device=device)
                             .manual_seed(seed))

    def encode(self, x):
        return self.encoder(x)

    def decode(self, z):
        return self.decoder(z)

    def forward(self, x):
        z = self.encode(x)
        return self.decode(z), z


@torch.no_grad()
def reset_parameters(module: nn.Module, generator: torch.Generator):
    """Kernels normal with std 1 / sqrt(fan_in) (flax draws lecun-normal,
    a truncated normal of that std), zero biases, unit norm scales."""
    for m in module.modules():
        if isinstance(m, (SameConv1d, UpConv1d)):
            fan_in = m.weight.shape[1] * m.weight.shape[2]
            m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()


def cast_weights_(module: nn.Module, dtype) -> nn.Module:
    """Store every convolution's weights in ``dtype`` (the compute dtype),
    as a serving copy holds them; norms keep float32."""
    for m in module.modules():
        if isinstance(m, (SameConv1d, UpConv1d)):
            m.to(dtype)
    return module
