"""The DC-AE video decoder (counterpart of owl_audio_exps_tpu/nn/dcae.py
``ChannelRMSNorm``, ``pixel_shuffle``, ``ResBlock``, ``GLUMBConv``,
``MultiscaleLinearAttention``, ``EfficientViTBlock``, ``DCUpBlock2d`` and
``DCAEDecoder``).

The decoder of diffusers' ``AutoencoderDC`` (dc-ae-f64c128 widths by
default): a conv stem with a channel-repeat shortcut, ResBlock and
EfficientViT stages walked deepest first, pixel-shuffle up blocks with
channel-duplicating shortcuts, RMS norms over channels, no final
activation. Module names are the diffusers decoder's, as
tests/dcae_torch_mirror.py has them (``up_blocks.i.j``,
``attn.to_qkv_multiscale.s.proj_in``), so a full ``AutoencoderDC``
state_dict loads with ``strict=True`` once its ``decoder.`` prefix is
stripped. Where diffusers and the JAX package might differ, this follows
the JAX package.

Tensors are NCHW in ``torch.channels_last`` memory (NHWC underneath, the
JAX package's layout): the channel RMS norm reduces over the innermost
axis with no copies, the reshapes of the pixel shuffle, the channel
repeats and the attention's head split run on the NHWC view, and cuDNN's
convolutions read NHWC. Convolutions and projections run in ``dtype``;
norms and both forms of the attention (the ReLU linear form when
h * w > head_dim, the normalised quadratic form otherwise) in float32, as
in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .layers import Linear

CL = torch.channels_last


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """The NHWC view of an NCHW tensor (free in channels_last memory)."""
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """The NCHW view of an NHWC tensor (channels_last when x is dense)."""
    return x.permute(0, 3, 1, 2)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """[b, c * r * r, h, w] -> [b, c, h * r, w * r], channel order
    ci * r * r + i * r + j (torch.nn.functional.pixel_shuffle's), computed
    on the NHWC view as the JAX function is."""
    b, crr, h, w = x.shape
    c = crr // (r * r)
    y = nhwc(x).reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return nchw(y.reshape(b, h * r, w * r, c))


def repeat_channels(x: torch.Tensor, reps: int) -> torch.Tensor:
    """Each channel ``reps`` times in a row (``jnp.repeat`` on the channel
    axis)."""
    return nchw(torch.repeat_interleave(nhwc(x), reps, dim=-1))


class Conv2d(nn.Module):
    """flax ``nn.Conv(out_ch, (k, k), padding="SAME")`` at stride 1 (odd
    k), weight [out, in / groups, k, k]."""

    def __init__(self, in_ch: int, out_ch: int, k: int, groups: int = 1,
                 bias: bool = True, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype, self.groups, self.pad = dtype, groups, k // 2
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups, k, k,
                                               device=device))
        self.bias = (nn.Parameter(torch.empty(out_ch, device=device))
                     if bias else None)

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), bias,
                        padding=self.pad, groups=self.groups)


class ChannelRMSNorm(nn.Module):
    """RMS norm over channels with scale and bias (diffusers
    RMSNorm(eps=1e-5, elementwise_affine=True, bias=True)), float32 math,
    the input's dtype out."""

    def __init__(self, features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(1, keepdim=True) + self.eps)
        return (y * self.weight.float()[:, None, None]
                + self.bias.float()[:, None, None]).to(x.dtype)


class ResBlock(nn.Module):
    """conv3x3 -> SiLU -> conv3x3 (no bias) -> RMS norm, + residual."""

    def __init__(self, features: int, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv1 = Conv2d(features, features, 3, **kw)
        self.conv2 = Conv2d(features, features, 3, bias=False, **kw)
        self.norm = ChannelRMSNorm(features, device=device)

    def forward(self, x):
        h = self.conv2(F.silu(self.conv1(x)))
        return self.norm(h) + x


class GLUMBConv(nn.Module):
    """1x1 expand (x2 for the gate), depthwise 3x3, x * SiLU(gate), 1x1
    project (no bias), RMS norm, + residual."""

    def __init__(self, features: int, expand: int = 4, dtype=torch.float32,
                 device=None):
        super().__init__()
        hidden = expand * features
        kw = dict(dtype=dtype, device=device)
        self.conv_inverted = Conv2d(features, hidden * 2, 1, **kw)
        self.conv_depth = Conv2d(hidden * 2, hidden * 2, 3,
                                 groups=hidden * 2, **kw)
        self.conv_point = Conv2d(hidden, features, 1, bias=False, **kw)
        self.norm = ChannelRMSNorm(features, device=device)

    def forward(self, x):
        h = self.conv_depth(F.silu(self.conv_inverted(x)))
        h, gate = h.chunk(2, dim=1)
        h = self.conv_point(h * F.silu(gate))
        return self.norm(h) + x


class MultiscaleProj(nn.Module):
    """One scale of the QKV aggregation: a depthwise k x k conv, then a
    1x1 conv grouped by head."""

    def __init__(self, inner: int, n_heads: int, ks: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        c = 3 * inner
        kw = dict(bias=False, dtype=dtype, device=device)
        self.proj_in = Conv2d(c, c, ks, groups=c, **kw)
        self.proj_out = Conv2d(c, c, 1, groups=3 * n_heads, **kw)

    def forward(self, x):
        return self.proj_out(self.proj_in(x))


class MultiscaleLinearAttention(nn.Module):
    """ReLU-kernel linear attention over multiscale depthwise-aggregated
    QKV (diffusers SanaMultiscaleLinearAttention); the normalised
    quadratic form on grids of at most ``head_dim`` positions."""

    def __init__(self, features: int, head_dim: int = 32,
                 kernel_sizes: Tuple[int, ...] = (5,), eps: float = 1e-15,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.head_dim, self.eps, self.dtype = head_dim, eps, dtype
        n_heads = features // head_dim
        inner = n_heads * head_dim
        kw = dict(bias=False, dtype=dtype, device=device)
        self.to_q = Linear(features, inner, **kw)
        self.to_k = Linear(features, inner, **kw)
        self.to_v = Linear(features, inner, **kw)
        self.to_qkv_multiscale = nn.ModuleList(
            [MultiscaleProj(inner, n_heads, k, dtype=dtype, device=device)
             for k in kernel_sizes])
        self.to_out = Linear(inner * (1 + len(kernel_sizes)), features, **kw)
        self.norm_out = ChannelRMSNorm(features, device=device)

    def forward(self, x):
        b, _, hh, ww = x.shape
        hd = self.head_dim
        w = torch.cat([self.to_q.weight, self.to_k.weight,
                       self.to_v.weight]).to(self.dtype)
        qkv = nchw(F.linear(nhwc(x).to(self.dtype), w))
        scales = [qkv] + [blk(qkv) for blk in self.to_qkv_multiscale]
        h = torch.cat([nhwc(s) for s in scales], dim=-1)
        # channel-major groups of 3 * head_dim (the JAX and torch reshape)
        L = hh * ww
        groups = h.shape[-1] // (3 * hd)
        q, k, v = h.reshape(b, L, groups, 3 * hd).split(hd, dim=-1)
        q, k, v = F.relu(q.float()), F.relu(k.float()), v.float()
        if L > hd:
            # linear form, O(L hd^2): v kᵀ and the key sums (the ones row)
            vk = torch.einsum("blgd,blge->bgde", v, k)
            num = torch.einsum("bgde,blge->blgd", vk, q)
            den = torch.einsum("bge,blge->blg", k.sum(1), q)
            out = num / (den[..., None] + self.eps)
        else:
            s = torch.einsum("blgd,bmgd->bglm", k, q)
            s = s / (s.sum(2, keepdim=True) + self.eps)
            out = torch.einsum("blgd,bglm->bmgd", v, s)
        out = out.reshape(b, hh, ww, groups * hd).to(x.dtype)
        out = nchw(self.to_out(out))
        return self.norm_out(out) + x


class EfficientViTBlock(nn.Module):
    def __init__(self, features: int, head_dim: int = 32,
                 kernel_sizes: Tuple[int, ...] = (5,), dtype=torch.float32,
                 device=None):
        super().__init__()
        self.attn = MultiscaleLinearAttention(
            features, head_dim, kernel_sizes, dtype=dtype, device=device)
        self.conv_out = GLUMBConv(features, dtype=dtype, device=device)

    def forward(self, x):
        return self.conv_out(self.attn(x))


class DCUpBlock2d(nn.Module):
    """2x upsample: conv3x3 to 4 x out channels, pixel shuffle, plus the
    parameter-free channel-duplicating shuffle of the input (one shuffle
    of the sum: the shuffle is a permutation)."""

    def __init__(self, in_features: int, out_features: int,
                 shortcut: bool = True, dtype=torch.float32, device=None):
        super().__init__()
        self.repeats = out_features * 4 // in_features if shortcut else 0
        self.conv = Conv2d(in_features, out_features * 4, 3, dtype=dtype,
                           device=device)

    def forward(self, x):
        h = self.conv(x)
        if self.repeats:
            h = h + repeat_channels(x, self.repeats)
        return pixel_shuffle(h, 2)


class DCAEDecoder(nn.Module):
    """Latent [b, latent_channels, h, w] -> image [b, 3, h * 2^(S-1),
    w * 2^(S-1)] (S stages; 8 x 8 -> 256 x 256 at the defaults), in
    ``dtype``, channels_last.

    ``device`` defaults to "cuda" and raises without a card; ``seed``
    draws the initial weights (None leaves them unset, as on the meta
    device)."""

    def __init__(self, latent_channels: int = 128,
                 block_out_channels: Sequence[int] = (128, 256, 512, 512,
                                                      1024, 1024),
                 block_types: Sequence[str] = (
                     "ResBlock", "ResBlock", "ResBlock", "EfficientViTBlock",
                     "EfficientViTBlock", "EfficientViTBlock"),
                 layers_per_block: Sequence[int] = (3, 5, 10, 2, 2, 2),
                 qkv_multiscales: Sequence[Tuple[int, ...]] = (
                     (), (), (), (5,), (5,), (5,)),
                 attention_head_dim: int = 32, out_channels: int = 3,
                 in_shortcut: bool = True, dtype=torch.float32,
                 device="cuda", seed: Optional[int] = 0):
        super().__init__()
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device)
        self.dtype = dtype
        n = len(block_out_channels)
        top = block_out_channels[-1]
        self.in_repeats = top // latent_channels if in_shortcut else 0
        self.conv_in = Conv2d(latent_channels, top, 3, **kw)
        up_blocks = []
        for i in range(n):
            stage = []
            if i < n - 1 and layers_per_block[i] > 0:
                stage.append(DCUpBlock2d(block_out_channels[i + 1],
                                         block_out_channels[i], **kw))
            for _ in range(layers_per_block[i]):
                if block_types[i] == "ResBlock":
                    stage.append(ResBlock(block_out_channels[i], **kw))
                else:
                    stage.append(EfficientViTBlock(
                        block_out_channels[i], attention_head_dim,
                        tuple(qkv_multiscales[i]), **kw))
            up_blocks.append(nn.Sequential(*stage))
        self.up_blocks = nn.ModuleList(up_blocks)
        self.norm_out = ChannelRMSNorm(block_out_channels[0], device=device)
        self.conv_out = Conv2d(block_out_channels[0], out_channels, 3, **kw)
        if seed is not None:
            reset_parameters(self, torch.Generator(device=device)
                             .manual_seed(seed))

    def forward(self, z):
        z = z.to(self.dtype).contiguous(memory_format=CL)
        h = self.conv_in(z)
        if self.in_repeats:
            h = h + repeat_channels(z, self.in_repeats)
        # deepest stage first
        for blk in reversed(self.up_blocks):
            h = blk(h)
        return self.conv_out(F.relu(self.norm_out(h)))


@torch.no_grad()
def reset_parameters(module: nn.Module, generator: torch.Generator):
    """Kernels normal with std 1 / sqrt(fan_in) (flax draws lecun-normal,
    a truncated normal of that std), zero biases, unit norm scales."""
    for m in module.modules():
        if isinstance(m, (Conv2d, Linear)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, ChannelRMSNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()


def cast_weights_(module: nn.Module, dtype) -> nn.Module:
    """Store the convolutions' and projections' weights in ``dtype`` (the
    compute dtype), the convolutions' in channels_last as cuDNN reads
    them; the norms keep float32."""
    for m in module.modules():
        if isinstance(m, Linear):
            m.to(dtype)
        elif isinstance(m, Conv2d):
            m.weight.data = m.weight.data.to(dtype, memory_format=CL)
            if m.bias is not None:
                m.bias.data = m.bias.data.to(dtype)
    return module
