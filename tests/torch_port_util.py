"""Shared helpers of the tests/test_torch_port_*.py files, which hold the
PyTorch port (owl_audio_exps_tpu_torch) against the JAX package on the
CPU: inputs are made with numpy from a seed and handed to both."""

from __future__ import annotations

import jax
import numpy as np
import torch

from owl_audio_exps_tpu.configs import transformer_config as jax_config
from owl_audio_exps_tpu_torch.configs import transformer_config as port_config
from owl_audio_exps_tpu_torch.utils.weights import params_from_jax

TINY_AV = dict(
    model_id="game_rft_audio", n_layers=2, n_heads=2, d_model=32,
    channels=4, audio_channels=4, sample_size=2, tokens_per_frame=5,
    n_frames=8, n_buttons=11, uncond=False, has_audio=True,
    rope_impl="ortho", local_window=2, global_window=None, cfg_prob=0.0)


def configs(**overrides):
    """(JAX config, port config) with the same keys."""
    kw = dict(TINY_AV, **overrides)
    return jax_config(**kw), port_config(**kw)


def numpy_params(params):
    return jax.tree.map(np.asarray, params)


def load_jax_params(module: torch.nn.Module, params, n_heads: int):
    """Load JAX params into a port module; every key must match."""
    module.load_state_dict(params_from_jax(numpy_params(params), n_heads),
                           strict=True)
    return module


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def av_inputs(rs: np.random.RandomState, b: int, n: int, cfg, dtype=np.float32):
    """(x, audio, t, mouse, btn) numpy inputs of the AV core."""
    p = cfg.sample_size
    return (rs.randn(b, n, cfg.channels, p, p).astype(dtype),
            rs.randn(b, n, cfg.audio_channels).astype(dtype),
            rs.rand(b, n).astype(dtype),
            rs.randn(b, n, 2).astype(dtype),
            (rs.rand(b, n, cfg.n_buttons) > 0.5).astype(dtype))
