"""Plain float32 reference of the benchmark's two world models: the
video DiT (dit_v4) and the joint audio-video DiT (av_v5), as
owl-audio-exps defines them, in plain torch operations.

Parameters are a dict {name: tensor} in the published checkpoint layout
(``param_spec`` lists every name and shape from the configuration). A
block is pre-AdaLN -> fused-QKV attention (QK rms-norm, RoPE) -> gate ->
residual, then pre-AdaLN -> MLP (SiLU, 4x) -> gate -> residual; layers
alternate one global and ``local_idx - 1`` local (windowed) layers.

Attention is left to the caller (``attend(layer, local, q, k, v)`` gets
q, k, v [B, H, L, Dh] after the QK norm and before RoPE), so that the
training reference runs ``blocked_attention`` over the whole sequence
and the serve reference runs attention over its own cache. The model's
inputs (latents and timesteps) arrive in bfloat16, as the published
models take them: the timesteps pass through a sin/cos embedding at
mult 1000, where the input's rounding is part of the model.

``precision="fp8"`` is the control: every matmul operand (the linear
layers' inputs and weights, and attention's q, k, v) rounded to float8
e4m3 with a per-tensor scale, and the gradients reaching a linear layer
to e5m2, the step below the bfloat16 that the configurations state.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


# ----------------------------------------------------------- parameters
def _linear(spec, name, n_in, n_out, bias=True, kind="uniform"):
    spec.append((f"{name}.weight", (n_out, n_in), n_in, kind))
    if bias:
        spec.append((f"{name}.bias", (n_out,), n_in,
                     "zero" if kind == "kaiming" else kind))


def _mlp(spec, name, n_in, n_mid, n_out):
    _linear(spec, f"{name}.fc1", n_in, n_mid, kind="kaiming")
    _linear(spec, f"{name}.fc2", n_mid, n_out, kind="kaiming")


def param_spec(cfg, prefix: str = "") -> List[Tuple[str, tuple, int, str]]:
    """[(name, shape, fan_in, init)] of the model of ``cfg``: the video
    core, or with ``has_audio`` the AV core. ``init`` is "uniform"
    (U(+-1/sqrt(fan_in))), "kaiming" (the MLPs' N(0, 2/fan_in^2) as a
    uniform of that variance) or "zero"."""
    d, s = cfg["d_model"], []
    p = prefix
    _mlp(s, f"{p}t_embed.mlp", 512, 4 * d, d)
    if not cfg.get("uncond", False):
        _linear(s, f"{p}control_embed.mouse.angle_proj", 2, 256, bias=False)
        _mlp(s, f"{p}control_embed.mouse.mlp", 512, 2048, d)
        _mlp(s, f"{p}control_embed.button.proj", cfg["n_buttons"], 2048, d)
    _linear(s, f"{p}proj_in", cfg["channels"], d, bias=False)
    if cfg.get("has_audio", False):
        _linear(s, f"{p}audio_proj_in", cfg["audio_channels"], d, bias=False)
    for i in range(cfg["n_layers"]):
        b = f"{p}transformer.blocks.{i}"
        _linear(s, f"{b}.attn.qkv", d, 3 * d)
        _linear(s, f"{b}.attn.out", d, d)
        _linear(s, f"{b}.adaln1.fc", d, 2 * d)
        _linear(s, f"{b}.gate1.fc_c", d, d)
        _mlp(s, f"{b}.mlp", d, 4 * d, d)
        _linear(s, f"{b}.adaln2.fc", d, 2 * d)
        _linear(s, f"{b}.gate2.fc_c", d, d)
    _linear(s, f"{p}proj_out.norm.fc", d, 2 * d)
    _linear(s, f"{p}proj_out.proj", d, cfg["channels"])
    if cfg.get("has_audio", False):
        _linear(s, f"{p}audio_proj_out.norm.fc", d, 2 * d)
        _linear(s, f"{p}audio_proj_out.proj", d, cfg["audio_channels"])
    return s


def local_flags(cfg) -> List[bool]:
    k = cfg.get("local_idx", 4) or 4
    return [i % k != 0 for i in range(cfg["n_layers"])]


# ------------------------------------------------------------ precision
class _Round(torch.autograd.Function):
    """Forward: round to float8 e4m3 (per-tensor scale); backward: the
    incoming gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return fp8_round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g, torch.float8_e5m2)


def fp8_round(x, dtype):
    amax = x.detach().abs().amax().float().clamp(min=1e-12)
    scale = amax / FP8_MAX[dtype]
    return ((x / scale).to(dtype).to(x.dtype)) * scale


class Prec:
    """The arithmetic of one reference run: float32 with TF32 off, or the
    fp8 control."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(precision)
        self.fp8 = precision == "fp8"

    def q(self, x):
        return _Round.apply(x) if self.fp8 else x

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)


# --------------------------------------------------------------- layers
def rms_norm(x, eps=1e-6):
    return F.rms_norm(x, (x.shape[-1],), eps=eps)


def layer_norm(x, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), eps=eps)


def sincos(x, dim, theta=300.0, mult=1000.0):
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                   device=x.device)
                      * -(math.log(theta) / (half - 1)))
    ang = (x.float() * mult)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def per_frame(x, c):
    """x [b, n*m, d] times per-frame c [b, n, d] broadcast per token."""
    b, nm, d = x.shape
    n = c.shape[1]
    return (x.reshape(b, n, nm // n, d) * c[:, :, None]).reshape(b, nm, d)


def per_frame_add(x, c):
    b, nm, d = x.shape
    n = c.shape[1]
    return (x.reshape(b, n, nm // n, d) + c[:, :, None]).reshape(b, nm, d)


class Model:
    """The reference model of ``cfg`` on the parameters ``p`` (float32
    dict, names as ``param_spec``)."""

    def __init__(self, cfg, p: Dict[str, torch.Tensor], prefix: str = "",
                 precision: str = "fp32", remat: bool = False):
        self.cfg, self.p, self.pre = cfg, p, prefix
        self.prec = Prec(precision)
        self.remat = remat
        self.flags = local_flags(cfg)

    def lin(self, name, x, bias=True):
        p = self.p
        return self.prec.linear(x, p[f"{self.pre}{name}.weight"],
                                p.get(f"{self.pre}{name}.bias")
                                if bias else None)

    def mlp(self, name, x):
        return self.lin(f"{name}.fc2", F.silu(self.lin(f"{name}.fc1", x)))

    def adaln(self, name, x, cond):
        a, b = self.lin(f"{name}.fc", F.silu(cond)).chunk(2, -1)
        return per_frame_add(per_frame(rms_norm(x), 1.0 + a), b)

    def final(self, name, x, cond):
        return self.lin(f"{name}.proj", F.silu(self.adaln(f"{name}.norm", x,
                                                          cond)))

    def cond(self, t, mouse, btn, has_controls):
        """Per-frame cond [b, n, d] from t [b, n] (bf16 values) and the
        controls."""
        c = self.mlp("t_embed.mlp", sincos(t, 512))
        if self.cfg.get("uncond", False):
            return c
        m = mouse.float()
        sym = torch.sign(m) * torch.log1p(m.abs())
        ang = torch.atan2(sym[..., 1], sym[..., 0])
        mag = torch.linalg.vector_norm(sym, dim=-1)
        a = self.lin("control_embed.mouse.angle_proj",
                     torch.stack([torch.cos(ang), torch.sin(ang)], -1),
                     bias=False)
        ctrl = self.mlp("control_embed.mouse.mlp",
                        torch.cat([a, sincos(mag, 256)], -1))
        ctrl = ctrl + self.mlp("control_embed.button.proj",
                               btn.float() * 2.0 - 1.0)
        if has_controls is not None:
            ctrl = ctrl * has_controls.float()[:, None, None]
        return c + ctrl

    def block(self, i, x, cond, attend):
        cfg, b = self.cfg, f"transformer.blocks.{i}"
        B, L, d = x.shape
        H = cfg["n_heads"]
        h = self.adaln(f"{b}.adaln1", x, cond)
        qkv = self.lin(f"{b}.attn.qkv", h).view(B, L, 3, H, d // H)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        o = attend(i, self.flags[i], rms_norm(q), rms_norm(k), v)
        o = self.lin(f"{b}.attn.out", o.transpose(1, 2).reshape(B, L, d))
        x = x + per_frame(o, self.lin(f"{b}.gate1.fc_c", F.silu(cond)))
        h = self.mlp(f"{b}.mlp", self.adaln(f"{b}.adaln2", x, cond))
        return x + per_frame(h, self.lin(f"{b}.gate2.fc_c", F.silu(cond)))

    def stack(self, x, cond, attend):
        for i in range(self.cfg["n_layers"]):
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(self.block, i, x, cond, attend,
                               use_reentrant=False)
            else:
                x = self.block(i, x, cond, attend)
        return x

    # ---- the two cores -------------------------------------------------
    def video(self, x, t, mouse, btn, has_controls, attend):
        """x [b, n, c, h, w], t [b, n] -> velocity [b, n, c, h, w]."""
        b, n, c, h, w = x.shape
        cond = self.cond(t, mouse, btn, has_controls)
        tok = self.lin("proj_in", x.permute(0, 1, 3, 4, 2)
                       .reshape(b, n * h * w, c), bias=False)
        tok = self.stack(tok, cond, attend)
        out = self.final("proj_out", tok, cond)
        return out.reshape(b, n, h, w, c).permute(0, 1, 4, 2, 3)

    def av(self, x, audio, t, mouse, btn, has_controls, attend):
        """(x [b, n, c, h, w], audio [b, n, c_a]) -> (v_video, v_audio);
        one stream of per-frame [64 video tokens | 1 audio token]."""
        b, n, c, h, w = x.shape
        cond = self.cond(t, mouse, btn, has_controls)
        vid = self.lin("proj_in", x.permute(0, 1, 3, 4, 2)
                       .reshape(b, n * h * w, c), bias=False)
        aud = self.lin("audio_proj_in", audio, bias=False)
        V, d = h * w, vid.shape[-1]
        s = torch.cat([vid.reshape(b, n, V, d), aud[:, :, None]], 2)
        s = self.stack(s.reshape(b, n * (V + 1), d), cond, attend)
        s = s.reshape(b, n, V + 1, d)
        video = self.final("proj_out", layer_norm(s[:, :, :-1]
                                                  .reshape(b, n * V, d)),
                           layer_norm(cond))
        video = video.reshape(b, n, h, w, c).permute(0, 1, 4, 2, 3)
        return video, self.final("audio_proj_out", s[:, :, -1], cond)


# ------------------------------------------------------------- attention
def rope(x, cos, sin):
    """Rotate interleaved pairs of x [..., L, Dh] by the angles' cos/sin
    [L, F] (the dims past 2F pass through)."""
    f = cos.shape[-1]
    x0, x1 = x[..., 0:2 * f:2], x[..., 1:2 * f:2]
    out = torch.stack([x0 * cos - x1 * sin, x1 * cos + x0 * sin], -1)
    out = out.flatten(-2)
    if 2 * f < x.shape[-1]:
        out = torch.cat([out, x[..., 2 * f:]], -1)
    return out


def frame_visibility(n_frames, window, causal, doc=None, device=None):
    """[n_frames, n_frames] (or [b, n, n] with per-frame ``doc``) bool:
    key frame visible to query frame."""
    f = torch.arange(n_frames, device=device)
    dist = f[:, None] - f[None, :]
    vis = torch.ones(n_frames, n_frames, dtype=torch.bool, device=device)
    if window is not None:
        vis &= dist.abs() < window
    if causal:
        vis &= dist >= 0
    if doc is None:
        return vis
    doc = doc.to(device)
    return vis[None] & (doc[:, :, None] == doc[:, None, :])


class _Blocked(torch.autograd.Function):
    """softmax(q k^T / sqrt(Dh)) v under a frame-level visibility, in
    blocks of query frames, each over the key frames its rows can see;
    the backward recomputes each block's scores."""

    @staticmethod
    def forward(ctx, q, k, v, vis, tpf, budget):
        out = torch.empty_like(q)
        lse = torch.empty(q.shape[:-1], dtype=q.dtype, device=q.device)
        blocks = _blocks(vis, tpf, q.shape[1], budget)
        scale = q.shape[-1] ** -0.5
        for b, f0, f1, k0, k1, m in blocks:
            s = torch.matmul(q[b, :, f0 * tpf:f1 * tpf] * scale,
                             k[b, :, k0 * tpf:k1 * tpf].transpose(-1, -2))
            s.masked_fill_(~m, float("-inf"))
            ls = torch.logsumexp(s, -1)
            s.sub_(ls[..., None]).exp_()
            out[b, :, f0 * tpf:f1 * tpf] = torch.matmul(
                s, v[b, :, k0 * tpf:k1 * tpf])
            lse[b, :, f0 * tpf:f1 * tpf] = ls
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.blocks, ctx.tpf = blocks, tpf
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        tpf, scale = ctx.tpf, q.shape[-1] ** -0.5
        dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
        di = (g * out).sum(-1)
        for b, f0, f1, k0, k1, m in ctx.blocks:
            qs, ks = slice(f0 * tpf, f1 * tpf), slice(k0 * tpf, k1 * tpf)
            s = torch.matmul(q[b, :, qs] * scale,
                             k[b, :, ks].transpose(-1, -2))
            p = s.masked_fill_(~m, float("-inf")).sub_(
                lse[b, :, qs, None]).exp_()
            dv[b, :, ks] += torch.matmul(p.transpose(-1, -2), g[b, :, qs])
            dp = torch.matmul(g[b, :, qs], v[b, :, ks].transpose(-1, -2))
            ds = p.mul_(dp.sub_(di[b, :, qs, None])).mul_(scale)
            del dp
            dq[b, :, qs] += torch.matmul(ds, k[b, :, ks])
            dk[b, :, ks] += torch.matmul(ds.transpose(-1, -2), q[b, :, qs])
        return dq, dk, dv, None, None, None


def _blocks(vis, tpf, H, budget):
    """[(batch row, q frame start, end, k frame start, end, token mask)]
    covering every visible pair: each block at most ``budget`` score
    elements over the heads, and at most twice its visible pairs (so a
    block stops at a document's edge and a window's band stays narrow)."""
    vis = vis if vis.ndim == 3 else vis[None]
    B, n, _ = vis.shape
    cols = torch.arange(n, device=vis.device)
    first = torch.where(vis, cols, n).amin(-1).tolist()
    last = torch.where(vis, cols, -1).amax(-1).tolist()
    seen = vis.sum(-1).tolist()
    out = []
    for b in range(B):
        f0 = 0
        while f0 < n:
            lo, hi, f1, got = first[b][f0], last[b][f0], f0 + 1, seen[b][f0]
            while f1 < n:
                nlo, nhi = min(lo, first[b][f1]), max(hi, last[b][f1])
                area = (f1 + 1 - f0) * (nhi + 1 - nlo)
                if H * area * tpf * tpf > budget or \
                        area > 2 * (got + seen[b][f1]):
                    break
                lo, hi, got, f1 = nlo, nhi, got + seen[b][f1], f1 + 1
            if got:
                m = vis[b, f0:f1, lo:hi + 1]
                m = m.repeat_interleave(tpf, 0).repeat_interleave(tpf, 1)
                out.append((b, f0, f1, lo, hi + 1, m))
            f0 = f1
    return out


def blocked_attention(q, k, v, vis, tpf, budget=2 ** 28):
    """q, k, v [B, H, L, Dh] float32, ``vis`` [n, n] or [B, n, n] frame
    visibility (``frame_visibility``)."""
    if vis.ndim == 3 and vis.shape[0] == 1 and q.shape[0] > 1:
        vis = vis.expand(q.shape[0], -1, -1)
    if vis.ndim == 2:
        vis = vis[None].expand(q.shape[0], -1, -1)
    return _Blocked.apply(q, k, v, vis, tpf, budget)


def train_attend(cfg, L, doc, precision: Prec, device):
    """The training reference's ``attend``: RoPE at positions 0..L-1, then
    blocked attention under the layer's mask (causal, its window, the
    documents of ``doc`` [b, n_frames] or None)."""
    from .rope import angles
    import numpy as np
    tpf = cfg["tokens_per_frame"]
    n = L // tpf
    frames = max(cfg["n_frames"], n)
    ang = torch.from_numpy(np.ascontiguousarray(
        angles(cfg, frames)[:L])).to(device)
    cos, sin = torch.cos(ang), torch.sin(ang)
    causal = bool(cfg.get("causal", True))
    vis = {loc: frame_visibility(n, cfg.get("local_window") if loc
                                 else cfg.get("global_window"), causal, doc,
                                 device)
           for loc in (False, True)}

    def attend(i, local, q, k, v):
        q, k = rope(q, cos, sin), rope(k, cos, sin)
        q, k, v = (precision.q(t) for t in (q, k, v))
        return blocked_attention(q, k, v, vis[local], tpf)

    return attend
