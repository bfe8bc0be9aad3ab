"""The port's GameRFTAudioCore and DiT against the JAX package.

JAX params are carried across with ``params_from_jax``; inputs are numpy
from a seed; both run in float32 on the CPU, where the JAX package takes
its dense attention path. The port runs either its dense path
(``attn_impl: auto`` on the CPU) or its frame-mask route
(``attn_impl: splash``, whose plain version runs on CPU tensors): the
same function. Tolerance: atol 1e-4 on outputs of magnitude ~1 after two
blocks (float32 reassociation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_audio_exps_tpu.models.gamerft_audio import (
    GameRFTAudioCore as JaxCore)
from owl_audio_exps_tpu.nn.attn import DiT as JaxDiT
from owl_audio_exps_tpu.utils.torch_import import export_torch_state_dict
from owl_audio_exps_tpu_torch.models import get_core_cls
from owl_audio_exps_tpu_torch.models.gamerft_audio import GameRFTAudioCore
from owl_audio_exps_tpu_torch.nn.attn import DiT, use_splash_path
from owl_audio_exps_tpu_torch.ops import splash
from owl_audio_exps_tpu_torch.utils.weights import params_from_jax

from torch_port_util import (av_inputs, configs, load_jax_params,
                             numpy_params, t)

ATOL = 1e-4


def _jax_core(jcfg, inputs):
    core = JaxCore(jcfg, dtype=jnp.float32)
    params = jax.jit(core.init)(jax.random.key(0),
                                *(jnp.asarray(a) for a in inputs))
    return core, params


def _port_core(pcfg, params):
    core = GameRFTAudioCore(pcfg, dtype=torch.float32, device="cpu",
                            seed=None)
    return load_jax_params(core, params, pcfg.n_heads)


@pytest.mark.parametrize("attn_impl", ["auto", "splash"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_core_matches_jax(causal, attn_impl):
    jcfg, pcfg = configs(causal=causal, attn_impl="auto")
    pcfg.attn_impl = attn_impl
    rs = np.random.RandomState(0)
    inputs = av_inputs(rs, 2, 4, jcfg)
    has_controls = np.array([True, False])
    jcore, params = _jax_core(jcfg, inputs)
    (vj, aj), _ = jax.jit(jcore.apply)(
        params, *(jnp.asarray(a) for a in inputs),
        has_controls=jnp.asarray(has_controls))
    port = _port_core(pcfg, params)
    before = splash.launches
    with torch.no_grad():
        vp, ap = port(*(t(a) for a in inputs),
                      has_controls=torch.from_numpy(has_controls))
    assert splash.launches == before
    assert vp.shape == vj.shape and ap.shape == aj.shape
    np.testing.assert_allclose(vp.numpy(), np.asarray(vj), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ap.numpy(), np.asarray(aj), atol=ATOL, rtol=0)


def test_uncond_core_matches_jax():
    jcfg, pcfg = configs(uncond=True, causal=False, local_window=3)
    inputs = av_inputs(np.random.RandomState(1), 1, 5, jcfg)
    jcore, params = _jax_core(jcfg, inputs)
    (vj, aj), _ = jax.jit(jcore.apply)(params,
                                       *(jnp.asarray(a) for a in inputs))
    with torch.no_grad():
        vp, ap = _port_core(pcfg, params)(*(t(a) for a in inputs))
    np.testing.assert_allclose(vp.numpy(), np.asarray(vj), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ap.numpy(), np.asarray(aj), atol=ATOL, rtol=0)


@pytest.mark.parametrize("uncond", [False, True])
def test_params_from_jax_covers_every_key(uncond):
    jcfg, pcfg = configs(uncond=uncond)
    inputs = av_inputs(np.random.RandomState(2), 1, 2, jcfg)
    _, params = _jax_core(jcfg, inputs)
    sd = params_from_jax(numpy_params(params), jcfg.n_heads)
    port = GameRFTAudioCore(pcfg, dtype=torch.float32, device="cpu")
    want = port.state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
    # the port's copy of the mapping agrees with the JAX package's own
    ref = export_torch_state_dict(numpy_params(params)["params"],
                                  jcfg.n_heads)
    assert set(ref) == set(sd)
    for k in ref:
        np.testing.assert_array_equal(sd[k].numpy(), ref[k])


@pytest.mark.parametrize("attn_impl", ["auto", "splash"])
def test_dit_with_documents_matches_jax(attn_impl):
    jcfg, pcfg = configs(causal=True, local_window=2, global_window=3)
    pcfg.attn_impl = attn_impl
    rs = np.random.RandomState(3)
    n, tpf, d = 6, jcfg.tokens_per_frame, jcfg.d_model
    x = rs.randn(2, n * tpf, d).astype(np.float32)
    cond = rs.randn(2, n, d).astype(np.float32)
    doc = np.array([[0, 0, 0, 1, 1, 1], [0, 1, 1, 1, 1, 2]], np.int32)
    jdit = JaxDiT(jcfg, dtype=jnp.float32)
    args = (jnp.asarray(x), jnp.asarray(cond), jnp.asarray(doc))
    params = jax.jit(jdit.init)(jax.random.key(0), *args)
    ref, _ = jax.jit(jdit.apply)(params, *args)
    dit = load_jax_params(DiT(pcfg, dtype=torch.float32), params,
                          jcfg.n_heads)
    with torch.no_grad():
        got = dit(t(x), t(cond), torch.from_numpy(doc))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def test_routing_and_unported_paths_raise():
    _, pcfg = configs(causal=True, local_window=2)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert not use_splash_path(pcfg, 1040, cpu)        # auto: card only
    assert use_splash_path(pcfg, 1040, cuda)
    assert not use_splash_path(pcfg, 520, cuda)         # short: dense
    assert not use_splash_path(pcfg, 1041, cuda)        # ragged frames
    pcfg.attn_impl = "splash"
    assert use_splash_path(pcfg, 20, cpu)
    pcfg.attn_impl = "dense"
    assert not use_splash_path(pcfg, 4096, cuda)

    inputs = [t(a) for a in av_inputs(np.random.RandomState(4), 1, 2,
                                      pcfg)]
    for impl in ("band", "band2", "chunked"):
        pcfg.attn_impl, pcfg.local_attn_impl = "splash", impl
        core = GameRFTAudioCore(pcfg, dtype=torch.float32, device="cpu")
        with pytest.raises(NotImplementedError, match="band and chunked"):
            core(*inputs)
    pcfg.local_attn_impl = "auto"
    with pytest.raises(NotImplementedError, match="cached serve slice"):
        core(*inputs, kv_cache=object())
    _, mm = configs(backbone="mmdit")
    with pytest.raises(NotImplementedError, match="mmdit"):
        GameRFTAudioCore(mm, device="cpu")
    assert get_core_cls("game_rft_audio") is GameRFTAudioCore
    with pytest.raises(NotImplementedError):
        get_core_cls("game_rft")
    with pytest.raises(ValueError):
        get_core_cls("no_such_model")
