"""RoPE angle tables of the two models, a frozen copy of the published
formulas (owl-audio-exps ``ortho`` and ``motion`` layouts), in numpy.

Both layouts are linear in the frame index, so attention under them
depends on the distance between frames alone: the serve reference rotates
at positions counted from any base frame it likes.
"""

from __future__ import annotations

import numpy as np


def _pixel_freqs(dim, max_freq, dt):
    return np.linspace(1.0, max_freq / 2.0, dim // 2, dtype=dt) * np.pi


def _lang_freqs(dim, theta, dt):
    return 1.0 / (theta ** (np.arange(0, dim, 2, dtype=dt)[: dim // 2]
                            / dim))


def _axial(dims, offsets, dim, max_freq, ext0, dt):
    freqs = _pixel_freqs(dim, max_freq, dt)
    out_dims = (dims[0] + ext0,) + tuple(dims[1:])
    parts = []
    for ax, d in enumerate(dims):
        n = d + (ext0 if ax == 0 else 0)
        if d == 1:
            pos = np.full((n,), -1.0, dtype=dt)
        elif n == d:
            pos = np.linspace(-1.0, 1.0, d, dtype=dt)
        else:
            step = dt(2.0 / (d - 1))
            pos = dt(-1.0) + step * np.arange(n, dtype=dt)
        pos = pos + offsets[ax]
        ang = np.repeat(pos[:, None] * freqs[None, :], 2, axis=-1)
        shape = [1] * len(dims) + [ang.shape[-1]]
        shape[ax] = n
        parts.append(ang.reshape(shape))
    target = tuple(out_dims) + (parts[0].shape[-1],)
    return np.concatenate([np.broadcast_to(a, target) for a in parts], -1)


def ortho(n_frames, frames, p, head_dim, dt=np.float32):
    """[frames * (p^2 + 1), head_dim // 2]; the audio token of a frame
    takes the (p, p) corner."""
    f = _axial((n_frames, p + 1, p + 1, 1), (0.0, 0.0, 0.0, 1.0),
               head_dim // 4, 256.0, frames - n_frames, dt)
    f = f.reshape(frames, p + 1, p + 1, -1)
    vid = f[:, :p, :p].reshape(frames, p * p, -1)
    aud = f[:, -1, -1][:, None, :]
    out = np.concatenate([vid, aud], 1).reshape(frames * (p * p + 1), -1)
    return np.ascontiguousarray(out[..., ::2])


def motion(frames, p, head_dim, theta=10000.0, ats_delta=2.0,
           dt=np.float32):
    """Diagonal space-time layout, [frames * (p^2 + 1), head_dim // 2]."""
    dim_t, dim_x, dim_y = head_dim * 2 // 8, head_dim * 3 // 8, \
        head_dim * 3 // 8
    base = _lang_freqs(dim_t + dim_x + dim_y, theta, dt)
    n_sp = (dim_x + dim_y) // 2
    fs, ft = base[:n_sp], base[n_sp:]
    fx, fy = fs[::2], fs[1::2]
    t = np.arange(frames, dtype=dt) * ats_delta
    h = np.arange(p, dtype=dt) - (p - 1) / 2.0
    w = np.arange(p, dtype=dt) - (p - 1) / 2.0
    tv = np.repeat(t, p * p)
    xv = tv + np.tile(np.repeat(w[None, :], p, 0).reshape(-1), frames)
    yv = tv + np.tile(np.repeat(h[:, None], p, 1).reshape(-1), frames)

    def inter(video, audio):
        return np.concatenate([video.reshape(frames, p * p), audio[:, None]],
                              1).reshape(-1)

    x = inter(xv, t)
    y = inter(yv, t + (p - 1) / 2.0 + 1.0)
    tt = inter(tv, t)
    ax, ay, at = x[:, None] * fx, y[:, None] * fy, tt[:, None] * ft
    xy = np.stack([ax, ay], -1).reshape(ax.shape[0], -1)
    return np.ascontiguousarray(np.concatenate([xy, at], -1))


def angles(cfg, frames, dt=np.float32):
    """The model's angle table over ``frames`` frames (at least the
    config's ``n_frames``), one row a token: [frames * tpf, head_dim //
    2] (the audio slot dropped for a video-only model), in ``dt``."""
    p = cfg["sample_size"]
    head_dim = cfg["d_model"] // cfg["n_heads"]
    impl = cfg.get("rope_impl", "ortho")
    if impl == "ortho":
        a = ortho(cfg["n_frames"], frames, p, head_dim, dt)
    elif impl == "motion":
        a = motion(frames, p, head_dim, cfg.get("rope_base", 10000.0),
                   cfg.get("rope_ats_delta", 2.0), dt)
    else:
        raise ValueError(f"rope_impl {impl!r}")
    if not cfg.get("has_audio", False):
        a = a.reshape(frames, p * p + 1, -1)[:, :-1].reshape(-1, a.shape[-1])
    return a
