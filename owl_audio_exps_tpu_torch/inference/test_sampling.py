"""Offline sampling driver (counterpart of the root
inference/test_sampling.py): load a config and checkpoint, run the
config's registered sampler on seeded context, report the speed and
optionally save the latents.

    python -m owl_audio_exps_tpu_torch.inference.test_sampling \\
        --config_path configs/dit_v4_tpu_e2e.yml --num_frames 8 \\
        [--ckpt_path step_6.pt] [--out latents.npy] [--device cpu]

Without ``--ckpt_path`` the core's weights are seeded. The context,
mouse and buttons are the JAX script's: ``np.random.RandomState(0)``
draws a context of 8 frames (16 tokens for ``audio_rft``), then the
mouse and buttons over the context and the new frames. The sampler's
own draws come from a ``torch.Generator`` seeded 1 (``sample`` also takes
them as ``noise``, as the sampler parity tests hand in the JAX
sampler's). The window samplers (``av_window``, ``av_causal``) take the
AV signature, which the JAX script never passes: for them the context
covers the sampler's window and an audio context is drawn after the
buttons. A sampler of the video signature on an AV core raises, as the
JAX script fails on one. The module keeps the root script's name; pytest
collects only ``tests/``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

N_CTX, AUDIO_CTX = 8, 16


def port_launches():
    """The port kernels' launch counters (ops/splash.py, ops/band.py,
    ops/band2.py), by kernel."""
    from ..ops import band, band2, splash
    return {"frame_attention_fwd": splash.launches,
            "band_attention_fwd": band.fwd_launches,
            "band2_attention_fwd": band2.fwd_launches,
            "ring_partial_fwd": splash.lse_launches}


def make_core(cfg, params=None, device="cuda"):
    """The config's core in bf16 on ``device``: seeded, or holding
    ``params`` (a state_dict of the core)."""
    from ..models import get_core_cls
    m = cfg.model
    core = get_core_cls(m.model_id)(m, dtype=torch.bfloat16, device=device,
                                    seed=0 if params is None else None)
    if params is not None:
        core.load_state_dict(params, strict=True)
    return core.to(torch.bfloat16).eval()


def inputs(cfg, sampler, num_frames: int, device="cuda"):
    """The seeded context and controls of the JAX script, bf16 on
    ``device``: (ctx,) for ``audio_rft``; (ctx, mouse, btn) for a
    video-signature sampler; (ctx, audio, mouse, btn) for a window
    sampler, whose context covers its window."""
    from ..sampling.av_window import AVWindowSampler
    m = cfg.model
    rs = np.random.RandomState(0)

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(
            device, torch.bfloat16)

    if m.model_id == "audio_rft":
        return (put(rs.randn(1, AUDIO_CTX, m.channels)),)
    av = isinstance(sampler, AVWindowSampler)
    n_ctx = max(N_CTX, sampler.window_length) if av else N_CTX
    total = n_ctx + num_frames
    ctx = put(rs.randn(1, n_ctx, m.channels, m.sample_size, m.sample_size))
    mouse = put(rs.randn(1, total, 2))
    btn = put(rs.rand(1, total, m.n_buttons) > 0.5)
    if av:
        return ctx, put(rs.randn(1, n_ctx, m.audio_channels)), mouse, btn
    return ctx, mouse, btn


def sample(cfg, params=None, num_frames: int = 60, device="cuda",
           generator=None, noise=None):
    """Run the config's sampler once; returns (latents, audio latents or
    None, wall seconds). ``noise`` (the sampler's draws, a
    ``SamplerNoise``) replaces ``generator``'s for the cached samplers."""
    from ..sampling import get_sampler_cls
    from ..utils.device import resolve_device
    device = resolve_device(device)
    core = make_core(cfg, params, device)
    skw = dict((cfg.train.sampler_kwargs or {}).items())
    skw["num_frames"] = num_frames
    sampler = get_sampler_cls(cfg.train.sampler_id)(**skw)
    args = inputs(cfg, sampler, num_frames, device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(1)
    kw = dict(generator=generator)
    if noise is not None:
        kw["noise"] = noise
    t0 = time.perf_counter()
    out = sampler(core, *args, **kw)
    audio = None
    if isinstance(out, tuple):        # the window samplers' six outputs
        latents, audio = out[2], out[3]
    else:
        latents = out
    latents.float().cpu()             # waits for the device
    return latents, audio, time.perf_counter() - t0


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--ckpt_path", default=None)
    parser.add_argument("--num_frames", type=int, default=60)
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from .. import from_pretrained
    from ..utils.checkpoints import unwrap_core
    cfg, params = from_pretrained(args.config_path, args.ckpt_path,
                                  device=args.device)
    if params is not None:
        params = unwrap_core(params)
    latents, audio, wall = sample(cfg, params, args.num_frames, args.device)
    extra = "" if audio is None else f", audio {tuple(audio.shape)}"
    print(f"sampled latents {tuple(latents.shape)}{extra} in {wall:.2f}s "
          f"({args.num_frames / wall:.2f} frames/s)")
    print(f"port kernel launches {port_launches()}")
    if args.out:
        np.save(args.out, latents.float().cpu().numpy())
    return latents


if __name__ == "__main__":
    main()
