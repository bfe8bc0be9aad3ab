"""Benchmark of the PyTorch/CUDA port: streaming audio generation real-time
factor (RTF) on one NVIDIA GPU.

The port's counterpart of bench.py, which stays the JAX package's bench:
the same model (``AudioRFTCore``, 16 layers x d 1024, 16 heads, 64
channels, one token per latent, ``local_window`` 16, 4096 frames of RoPE
table) and the same serve (``AudioCachingSampler``: 2 steps at [1.0, 0.5],
``noise_prev`` 0.2, a 120-token ring, 240 new tokens, batch 1), with
seeded bf16 weights and the context from numpy seed 0. One warm-up run
(which also captures the token step's CUDA graph), then the median of 3
timed runs, each ending in a host copy of the output. RTF is audio
seconds per wall-clock second: batch x (240 / 60) / wall, each latent
spanning 1/60 s. ``production`` adds int8 weight-only serving on one
stream and 32 streams with int8 weights and int8 KV rings (their
aggregate RTF).

    python3 bench_torch.py

Needs a CUDA device and exits non-zero without one. Prints one JSON line:
{"metric", "value", "unit", "vs_baseline", "production", "device"}.
"""

import json
import statistics
import subprocess
import time

import numpy as np
import torch

LATENTS_PER_SECOND = 60.0
NUM_TOKENS = 240
INIT_LEN = 120


def make_cfg(**kw):
    from owl_audio_exps_tpu_torch.configs import transformer_config
    return transformer_config(
        model_id="audio_rft", sample_size=120, channels=64,
        n_layers=16, n_heads=16, d_model=1024,
        tokens_per_frame=1, n_frames=4096,
        cfg_prob=0.0, causal=True, uncond=True, backbone="dit",
        has_audio=True, rope_impl="audio1d",
        local_window=16, global_window=None, **kw)


def make_core(cfg, device):
    from owl_audio_exps_tpu_torch.models.audiorft import AudioRFTCore
    return AudioRFTCore(cfg, dtype=torch.bfloat16, device=device,
                        seed=0).to(torch.bfloat16).eval()


def make_sampler():
    from owl_audio_exps_tpu_torch.sampling.audio_caching import (
        AudioCachingSampler)
    return AudioCachingSampler(n_steps=2, num_tokens=NUM_TOKENS,
                               noise_prev=0.2, custom_schedule=[1.0, 0.5],
                               max_window=120)


def measure(run, x, n_iters: int = 3) -> float:
    """Audio seconds per second of ``run(x, generator)`` (a sampler call):
    the median of ``n_iters`` timed runs after one warm-up run."""
    gen = torch.Generator(device=x.device)
    run(x, gen.manual_seed(1)).cpu()
    times = []
    for i in range(n_iters):
        t0 = time.perf_counter()
        out = run(x, gen.manual_seed(2 + i))
        out.cpu()
        times.append(time.perf_counter() - t0)
    if not torch.isfinite(out).all():
        raise RuntimeError("non-finite latents")
    return x.shape[0] * (NUM_TOKENS / LATENTS_PER_SECOND) \
        / statistics.median(times)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main():
    from owl_audio_exps_tpu_torch.nn.wquant import quantize_params_int8
    from owl_audio_exps_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    cfg = make_cfg()
    core = make_core(cfg, dev)
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(1, INIT_LEN, cfg.channels)).to(
        dev, torch.bfloat16)
    sampler = make_sampler()

    def serve(core):
        return lambda x, gen: sampler(core, x, generator=gen)

    rtf = measure(serve(core), x)
    int8_rtf = measure(serve(quantize_params_int8(core)), x)
    core32 = quantize_params_int8(make_core(make_cfg(kv_quant="int8"), dev))
    x32 = torch.from_numpy(rs.randn(32, INIT_LEN, 64)).to(dev, torch.bfloat16)
    agg_rtf = measure(serve(core32), x32)

    print(json.dumps({
        "metric": "streaming_audio_rtf",
        "value": round(rtf, 4),
        "unit": "audio_sec_per_sec_per_chip",
        "vs_baseline": round(rtf / 1.0, 4),
        "production": {"int8_rtf": round(int8_rtf, 2),
                       "int8_32stream_agg_rtf": round(agg_rtf, 1)},
        "device": {"kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count(), "card": card()},
    }), flush=True)


if __name__ == "__main__":
    main()
