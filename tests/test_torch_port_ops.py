"""The port's configs, ops, layers and embeddings against the JAX package.

Inputs are made with numpy from a seed and run through both in float32
on the CPU. Tolerance: atol 1e-5 (float32 rounding of the same
operations taken in another order), except 1e-4 for the raw sincos
embedding, whose angles reach 1000 rad; the RoPE angle tables are numpy
in both and compared exactly.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_audio_exps_tpu import configs as jcfg
from owl_audio_exps_tpu.nn import embeddings as jemb
from owl_audio_exps_tpu.nn import layers as jlayers
from owl_audio_exps_tpu.ops import attention as jattn
from owl_audio_exps_tpu.ops import masks as jmasks
from owl_audio_exps_tpu.ops import norms as jnorms
from owl_audio_exps_tpu.ops import rope as jrope
from owl_audio_exps_tpu_torch import configs as pcfg
from owl_audio_exps_tpu_torch.nn import embeddings as pemb
from owl_audio_exps_tpu_torch.nn import layers as players
from owl_audio_exps_tpu_torch.ops import attention as pattn
from owl_audio_exps_tpu_torch.ops import masks as pmasks
from owl_audio_exps_tpu_torch.ops import norms as pnorms
from owl_audio_exps_tpu_torch.ops import rope as prope

from torch_port_util import configs, load_jax_params, t

ATOL = 1e-5
F32 = jnp.float32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yml")))


def close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=0)


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("path", YAMLS, ids=os.path.basename)
def test_config_yaml_matches_jax(path):
    assert pcfg.Config.from_yaml(path).to_dict() == \
        jcfg.Config.from_yaml(path).to_dict()


def test_config_open_schema_and_defaults():
    kw = dict(n_layers=3, some_unknown_key={"a": 1}, local_window=4)
    p, j = pcfg.transformer_config(**kw), jcfg.transformer_config(**kw)
    assert p.to_dict() == j.to_dict()
    assert p.some_unknown_key.a == 1 and p.get("missing", 7) == 7
    assert pcfg.MODEL_DEFAULTS.keys() == jcfg.MODEL_DEFAULTS.keys()


# ------------------------------------------------------------------- norms
@pytest.mark.parametrize("fn", ["rms_norm", "layer_norm"])
def test_norms(fn):
    x = np.random.RandomState(0).randn(3, 7, 48).astype(np.float32) * 3 + 1
    close(getattr(pnorms, fn)(t(x)), getattr(jnorms, fn)(jnp.asarray(x)))


# ------------------------------------------------------------------- masks
MASK_CASES = [  # n_tokens, tpf, window, causal, docs
    (40, 5, None, True, False),
    (40, 5, 3, True, False),
    (40, 5, 3, False, False),
    (42, 5, 2, True, True),
    (36, 4, None, False, True),
]


@pytest.mark.parametrize("n,tpf,window,causal,docs", MASK_CASES)
def test_dense_mask(n, tpf, window, causal, docs):
    nf = -(-n // tpf)
    doc = None
    if docs:
        doc = np.stack([np.arange(nf) >= nf // 2,
                        np.arange(nf) >= 1]).astype(np.int32)
    ref = jmasks.dense_mask(n, tpf, window,
                            None if doc is None else jnp.asarray(doc), 0,
                            causal)
    got = pmasks.dense_mask(n, tpf, window,
                            None if doc is None else t(doc).long(), 0, causal)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(pmasks.frame_ids(n, tpf),
                                  jmasks.frame_ids(n, tpf))


@pytest.mark.parametrize("mask_kind", ["none", "shared", "per_batch"])
def test_dot_attention(mask_kind):
    rs = np.random.RandomState(1)
    q, k, v = (rs.randn(2, 3, 20, 16).astype(np.float32) for _ in range(3))
    mask = None
    if mask_kind == "shared":
        mask = np.asarray(jmasks.dense_mask(20, 4, 2, None, 0, True))
    elif mask_kind == "per_batch":
        doc = np.array([[0, 0, 1, 1, 1], [0, 1, 1, 1, 1]], np.int32)
        mask = np.asarray(jmasks.dense_mask(20, 4, None, jnp.asarray(doc), 0,
                                            True))
    ref = jattn.dot_attention(*(jnp.asarray(a) for a in (q, k, v)),
                              None if mask is None else jnp.asarray(mask))
    got = pattn.dot_attention(t(q), t(k), t(v),
                              None if mask is None else t(mask))
    close(got, ref)


# -------------------------------------------------------------------- rope
@pytest.mark.parametrize("impl", ["ortho", "motion", "audio1d"])
@pytest.mark.parametrize("has_audio", [True, False])
def test_rope_tables(impl, has_audio):
    j, p = configs(rope_impl=impl, has_audio=has_audio, d_model=64,
                   n_heads=2, sample_size=4)
    np.testing.assert_array_equal(prope.get_rope_freqs(p),
                                  jrope.get_rope_freqs(j))


@pytest.mark.parametrize("impl", ["ortho", "motion"])
def test_apply_rope(impl):
    j, p = configs(rope_impl=impl, d_model=64, n_heads=2)
    rs = np.random.RandomState(2)
    x = rs.randn(2, 2, 30, 32).astype(np.float32)
    pos = np.arange(30) + 3
    pos[-1] = 10_000   # past the table: clipped in both
    ref = jrope.rope_table_for(j)(jnp.asarray(x), jnp.asarray(pos))
    got = prope.rope_table_for(p)(t(x), torch.as_tensor(pos))
    close(got, ref)


# ------------------------------------------------------------------ layers
def _flax(module, *args):
    params = module.init(jax.random.key(0), *args)
    return params, module.apply(params, *args)


def _check_module(jmod, pmod, *np_args, n_heads=1):
    params, ref = _flax(jmod, *(jnp.asarray(a) for a in np_args))
    load_jax_params(pmod, params, n_heads)
    close(pmod(*(t(a) for a in np_args)), ref)


def test_linear_and_mlps():
    x = np.random.RandomState(3).randn(2, 6, 24).astype(np.float32)
    _check_module(jlayers.Linear(40, dtype=F32),
                  players.Linear(24, 40, dtype=torch.float32), x)
    _check_module(jlayers.Linear(40, use_bias=False, dtype=F32),
                  players.Linear(24, 40, bias=False, dtype=torch.float32), x)
    _check_module(jlayers.MLP(24, dtype=F32),
                  players.MLP(24, dtype=torch.float32), x)
    _check_module(jlayers.MLPCustom(64, 16, dtype=F32),
                  players.MLPCustom(24, 64, 16, dtype=torch.float32), x)


@pytest.mark.parametrize("cls", ["AdaLN", "Gate"])
def test_modulation_layers(cls):
    rs = np.random.RandomState(4)
    x = rs.randn(2, 3 * 5, 24).astype(np.float32)
    cond = rs.randn(2, 3, 24).astype(np.float32)
    _check_module(getattr(jlayers, cls)(24, dtype=F32),
                  getattr(players, cls)(24, dtype=torch.float32), x, cond)


def test_final_layer():
    rs = np.random.RandomState(5)
    x = rs.randn(2, 3 * 4, 24).astype(np.float32)
    cond = rs.randn(2, 3, 24).astype(np.float32)
    _check_module(jlayers.FinalLayer(24, 7, dtype=F32),
                  players.FinalLayer(24, 7, dtype=torch.float32), x, cond)


def test_token_broadcast_helpers():
    rs = np.random.RandomState(6)
    x = rs.randn(2, 12, 8).astype(np.float32)
    a, b = (rs.randn(2, 3, 8).astype(np.float32) for _ in range(2))
    close(players.broadcast_cond(t(a), 12),
          jlayers.broadcast_cond(jnp.asarray(a), 12))
    close(players.modulate_tokens(t(x), t(a), t(b)),
          jlayers.modulate_tokens(*(jnp.asarray(v) for v in (x, a, b))))
    close(players.gate_tokens(t(x), t(a)),
          jlayers.gate_tokens(jnp.asarray(x), jnp.asarray(a)))


def test_init_distributions_follow_torch_defaults():
    gen = torch.Generator().manual_seed(0)
    lin = players.Linear(400, 300)
    lin.reset_parameters(gen)
    assert lin.weight.abs().max() <= 400 ** -0.5
    mlp = players.MLPCustom(400, 800, 10)
    players.reset_parameters(mlp, gen)
    assert float(mlp.fc1.bias.detach().abs().max()) == 0.0
    std = float(mlp.fc1.weight.detach().std())
    assert abs(std - 2 ** 0.5 / 400) < 0.05 * 2 ** 0.5 / 400


# -------------------------------------------------------------- embeddings
def test_sincos_embed():
    x = np.random.RandomState(7).rand(3, 5).astype(np.float32)
    close(pemb.sincos_embed(t(x), 64), jemb.sincos_embed(jnp.asarray(x), 64),
          atol=1e-4)


def test_timestep_embedding():
    x = np.random.RandomState(8).rand(2, 5).astype(np.float32)
    _check_module(jemb.TimestepEmbedding(32, dtype=F32),
                  pemb.TimestepEmbedding(32, dtype=torch.float32), x)


def test_control_embeddings():
    rs = np.random.RandomState(9)
    mouse = rs.randn(2, 5, 2).astype(np.float32) * 4
    mouse[0, 0] = 0.0   # atan2(0, 0) and a zero magnitude
    btn = (rs.rand(2, 5, 11) > 0.5).astype(np.float32)
    _check_module(jemb.MouseEmbedding(32, dtype=F32),
                  pemb.MouseEmbedding(32, dtype=torch.float32), mouse)
    _check_module(jemb.ButtonEmbedding(32, dtype=F32),
                  pemb.ButtonEmbedding(11, 32, dtype=torch.float32), btn)
    _check_module(jemb.ControlEmbedding(11, 32, dtype=F32),
                  pemb.ControlEmbedding(11, 32, dtype=torch.float32),
                  mouse, btn)
