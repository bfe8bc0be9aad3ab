"""Rotary position embeddings (counterpart of owl_audio_exps_tpu/ops/rope.py).

The angle tables are numpy float32, computed once per config:

* ``ortho``   — axial time x height x width frequencies with a corner slot
  for the per-frame audio token;
* ``motion``  — diagonal space-time layout;
* ``audio1d`` — plain 1D temporal.

``apply_rope`` rotates interleaved pairs in place,
out[2i] = x[2i]·c − x[2i+1]·s and out[2i+1] = x[2i+1]·c + x[2i]·s,
in float32, at absolute token positions (clipped to the table).
"""

from __future__ import annotations

import numpy as np
import torch


def _pixel_freqs(dim: int, max_freq: float) -> np.ndarray:
    return np.linspace(1.0, max_freq / 2.0, dim // 2, dtype=np.float32) * np.pi


def _lang_freqs(dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32)[: dim // 2]
                            / dim))


def _axial_freqs_pixel(dims, offsets, dim: int, max_freq: float,
                       ext0: int = 0) -> np.ndarray:
    """Per axis: pos = linspace(-1, 1, d) + offset, angles = pos x freqs
    repeat-interleaved by 2; axes broadcast and concatenate on features.
    ``ext0`` extends axis 0 past +1 at the same step (decode headroom)."""
    freqs = _pixel_freqs(dim, max_freq)
    per_axis = []
    out_dims = (dims[0] + ext0,) + tuple(dims[1:])
    for ind, d in enumerate(dims):
        n = d + (ext0 if ind == 0 else 0)
        if d == 1:
            pos = np.full((n,), -1.0, dtype=np.float32)
        elif n == d:
            pos = np.linspace(-1.0, 1.0, d, dtype=np.float32)
        else:
            step = np.float32(2.0 / (d - 1))
            pos = np.float32(-1.0) + step * np.arange(n, dtype=np.float32)
        pos = pos + (offsets[ind] if offsets is not None else 0.0)
        ang = np.repeat(pos[:, None] * freqs[None, :], 2, axis=-1)
        shape = [1] * len(dims) + [ang.shape[-1]]
        shape[ind] = n
        per_axis.append(ang.reshape(shape))
    target = tuple(out_dims) + (per_axis[0].shape[-1],)
    return np.concatenate([np.broadcast_to(a, target) for a in per_axis],
                          axis=-1)


def _table_frames(config) -> int:
    """Frame rows the tables cover: ``n_frames`` plus decode headroom
    (``rope_headroom`` frames, default ``n_frames``)."""
    headroom = config.get("rope_headroom")
    if headroom is None:
        headroom = config.n_frames
    return config.n_frames + int(headroom)


def ortho_freqs(config) -> np.ndarray:
    """[F * (p^2 + 1), head_dim // 2] angles; the audio token takes the
    (p, p) corner slot."""
    p = config.sample_size
    head_dim = config.d_model // config.n_heads
    F = _table_frames(config)
    freqs = _axial_freqs_pixel(
        (config.n_frames, p + 1, p + 1, 1),
        offsets=(0.0, 0.0, 0.0, 1.0),
        dim=head_dim // 4,
        max_freq=256.0,
        ext0=F - config.n_frames,
    ).reshape(F, p + 1, p + 1, -1)
    vid = freqs[:, :p, :p].reshape(F, p * p, -1)
    aud = freqs[:, -1, -1][:, None, :]
    out = np.concatenate([vid, aud], axis=1).reshape(F * (p * p + 1), -1)
    return np.ascontiguousarray(out[..., ::2])


def motion_freqs(config) -> np.ndarray:
    """Diagonal space-time layout: [F * (H*W + 1), head_dim // 2]."""
    H = W = config.sample_size
    F = _table_frames(config)
    d_head = config.d_model // config.n_heads
    dim_t = config.get("rope_dim_t", d_head * 2 // 8)
    dim_x = config.get("rope_dim_x", d_head * 3 // 8)
    dim_y = config.get("rope_dim_y", d_head * 3 // 8)
    theta = config.get("rope_base", 10000.0)
    ats_delta = config.get("rope_ats_delta", 2.0)

    base = _lang_freqs(dim_t + dim_x + dim_y, theta)
    n_spatial = (dim_x + dim_y) // 2
    freqs_spatial, freqs_t = base[:n_spatial], base[n_spatial:]
    freqs_x, freqs_y = freqs_spatial[::2], freqs_spatial[1::2]

    t_grid = np.arange(F, dtype=np.float32) * ats_delta
    h_grid = np.arange(H, dtype=np.float32) - (H - 1) / 2.0
    w_grid = np.arange(W, dtype=np.float32) - (W - 1) / 2.0
    t_video = np.repeat(t_grid, H * W)
    x_video = t_video + np.tile(np.repeat(w_grid[None, :], H, 0).reshape(-1), F)
    y_video = t_video + np.tile(np.repeat(h_grid[:, None], W, 1).reshape(-1), F)
    t_audio = t_grid
    x_audio = t_audio
    y_audio = t_audio + (H - 1) / 2.0 + 1.0

    def interleave(video, audio):
        video = video.reshape(F, H * W)
        return np.concatenate([video, audio[:, None]], axis=1).reshape(-1)

    x_pos = interleave(x_video, x_audio)
    y_pos = interleave(y_video, y_audio)
    t_pos = interleave(t_video, t_audio)
    ang_x = x_pos[:, None] * freqs_x[None, :]
    ang_y = y_pos[:, None] * freqs_y[None, :]
    ang_t = t_pos[:, None] * freqs_t[None, :]
    inter = np.stack([ang_x, ang_y], axis=-1).reshape(ang_x.shape[0], -1)
    return np.ascontiguousarray(np.concatenate([inter, ang_t], axis=-1))


def audio1d_freqs(config) -> np.ndarray:
    """Pure temporal angles [F, head_dim // 2]."""
    head_dim = config.d_model // config.n_heads
    freqs = _lang_freqs(head_dim, 10000.0)
    pos = np.arange(_table_frames(config), dtype=np.float32)
    return np.ascontiguousarray(pos[:, None] * freqs[None, :])


_ROPE_FREQS = {
    "ortho": ortho_freqs,
    "motion": motion_freqs,
    "audio1d": audio1d_freqs,
}


def get_rope_freqs(config) -> np.ndarray:
    """Angle table for ``config.rope_impl``; without ``has_audio`` the
    per-frame audio slot is removed."""
    impl = (config.get("rope_impl", "ortho") or "ortho").lower()
    if impl not in _ROPE_FREQS:
        raise ValueError(f"Invalid RoPE impl: {impl}")
    freqs = _ROPE_FREQS[impl](config)
    if not config.get("has_audio", False):
        freqs = freqs.reshape(_table_frames(config), -1, freqs.shape[-1])
        freqs = freqs[:, :-1].reshape(-1, freqs.shape[-1])
    return freqs


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """x: [..., t, head_dim]; cos/sin: [n_tokens, F] float32 tables (the
    un-rotated tail past 2F passes through); positions: [t] int64."""
    f = cos.shape[-1]
    positions = positions.clamp(0, cos.shape[0] - 1)
    c = cos[positions]
    s = sin[positions]
    xr = x[..., : 2 * f].float()
    x0, x1 = xr[..., 0::2], xr[..., 1::2]
    out = torch.stack([x0 * c - x1 * s, x1 * c + x0 * s], dim=-1)
    out = out.flatten(-2).to(x.dtype)
    if 2 * f < x.shape[-1]:
        out = torch.cat([out, x[..., 2 * f:]], dim=-1)
    return out


class RopeTable:
    """cos/sin tables of one config, kept per device."""

    def __init__(self, config):
        angles = get_rope_freqs(config)
        self.cos_np = np.cos(angles).astype(np.float32)
        self.sin_np = np.sin(angles).astype(np.float32)
        self._dev = {}

    def tables(self, device):
        key = str(device)
        if key not in self._dev:
            self._dev[key] = (torch.from_numpy(self.cos_np).to(device),
                              torch.from_numpy(self.sin_np).to(device))
        return self._dev[key]

    def __call__(self, x: torch.Tensor, positions: torch.Tensor):
        cos, sin = self.tables(x.device)
        return apply_rope(x, cos, sin, positions)


_TABLE_CACHE: dict = {}


def rope_table_for(config) -> RopeTable:
    """Memoized RopeTable keyed on the config fields the tables use."""
    key = (
        config.get("rope_impl", "ortho"), config.n_frames, config.sample_size,
        config.d_model, config.n_heads, bool(config.get("has_audio", False)),
        config.get("rope_dim_t"), config.get("rope_dim_x"),
        config.get("rope_dim_y"), config.get("rope_base"),
        config.get("rope_ats_delta"), config.get("rope_headroom"),
    )
    if key not in _TABLE_CACHE:
        _TABLE_CACHE[key] = RopeTable(config)
    return _TABLE_CACHE[key]
