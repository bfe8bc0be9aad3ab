"""The port's GameRFTAudioCore and DiT against the JAX package.

JAX params are carried across with ``params_from_jax``; inputs are numpy
from a seed; both run in float32 on the CPU, where the JAX package takes
its dense attention path. The port runs either its dense path
(``attn_impl: auto`` on the CPU) or its frame-mask route
(``attn_impl: splash``, whose plain version runs on CPU tensors): the
same function. Tolerance: atol 1e-4 on outputs of magnitude ~1 after two
blocks (float32 reassociation).
"""

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
from owl_audio_exps_tpu_torch.nn.attn import (DiT, attention_route,
                                              use_splash_path)
from owl_audio_exps_tpu_torch.ops import splash
from owl_audio_exps_tpu_torch.utils.weights import params_from_jax

from torch_port_util import (av_inputs, carried, configs, jax_apply, jax_core,
                             jax_init, load_jax_params, numpy_params, t)

ATOL = 1e-4


@pytest.mark.parametrize("attn_impl", ["auto", "splash"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_core_matches_jax(causal, attn_impl):
    jcfg, pcfg = configs(causal=causal, attn_impl="auto")
    pcfg.attn_impl = attn_impl
    rs = np.random.RandomState(0)
    inputs = av_inputs(rs, 2, 4, jcfg)
    has_controls = np.array([True, False])
    jcore, params = jax_core(JaxCore, jcfg, *inputs)
    (vj, aj), _ = jax_apply(jcore, params, *inputs,
                            has_controls=has_controls)
    port = carried(GameRFTAudioCore, pcfg, params)
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
    jcore, params = jax_core(JaxCore, jcfg, *inputs)
    (vj, aj), _ = jax_apply(jcore, params, *inputs)
    with torch.no_grad():
        vp, ap = carried(GameRFTAudioCore, pcfg, params)(
            *(t(a) for a in inputs))
    np.testing.assert_allclose(vp.numpy(), np.asarray(vj), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ap.numpy(), np.asarray(aj), atol=ATOL, rtol=0)


@pytest.mark.parametrize("uncond", [False, True])
def test_params_from_jax_covers_every_key(uncond):
    jcfg, pcfg = configs(uncond=uncond)
    inputs = av_inputs(np.random.RandomState(2), 1, 2, jcfg)
    _, params = jax_core(JaxCore, jcfg, *inputs)
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
    jdit, params = jax_init(JaxDiT(jcfg, dtype=jnp.float32), x, cond, doc)
    ref, _ = jax_apply(jdit, params, x, cond, doc)
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

    # a pinned band runs where its span divides the sequence (32 frames x
    # 5 tokens, 2 chunks) and gives the frame-mask route's output, and so
    # does a pinned chunked (ops/local.py) and a pinned band2 (below)
    _, bcfg = configs(causal=True, local_window=32, attn_impl="splash",
                      local_attn_impl="band")
    binputs = [t(a) for a in av_inputs(np.random.RandomState(5), 1, 64,
                                       bcfg)]
    bcore = GameRFTAudioCore(bcfg, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        vb, ab = bcore(*binputs)
        bcfg.local_attn_impl = "splash"
        vs, as_ = bcore(*binputs)
    torch.testing.assert_close(vb, vs, atol=ATOL, rtol=0)
    torch.testing.assert_close(ab, as_, atol=ATOL, rtol=0)
    bcfg.local_attn_impl = "chunked"
    with torch.no_grad():
        vc, ac = bcore(*binputs)
    torch.testing.assert_close(vc, vs, atol=ATOL, rtol=0)
    torch.testing.assert_close(ac, as_, atol=ATOL, rtol=0)
    # band2 needs a plan: the AV token layout (8 x 8 + 1 = 65 a frame),
    # 32 frames and a 16-frame window give (520, 2)
    _, b2cfg = configs(causal=True, sample_size=8, tokens_per_frame=65,
                       local_window=16, attn_impl="splash",
                       local_attn_impl="band2")
    assert attention_route(b2cfg, True, 32 * 65) == ("band2", (520, 2))
    b2inputs = [t(a) for a in av_inputs(np.random.RandomState(6), 1, 32,
                                        b2cfg)]
    b2core = GameRFTAudioCore(b2cfg, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        v2, a2 = b2core(*b2inputs)
        b2cfg.local_attn_impl = "splash"
        vs2, as2 = b2core(*b2inputs)
    torch.testing.assert_close(v2, vs2, atol=ATOL, rtol=0)
    torch.testing.assert_close(a2, as2, atol=ATOL, rtol=0)

    inputs = [t(a) for a in av_inputs(np.random.RandomState(4), 1, 2,
                                      pcfg)]
    pcfg.attn_impl, pcfg.local_attn_impl = "splash", "auto"
    core = GameRFTAudioCore(pcfg, dtype=torch.float32, device="cpu")
    # cached forwards run (nn/kv_cache.py); a pinned decode_impl other
    # than auto/dense raises
    from owl_audio_exps_tpu_torch.nn.kv_cache import KVCache
    cache = KVCache.from_config(pcfg, 1, capacity_frames=4,
                                dtype=torch.float32, device="cpu")
    pcfg.decode_impl = "flash"
    with pytest.raises(ValueError, match="decode_impl"):
        core(*inputs, kv_cache=cache)
    pcfg.decode_impl = "auto"
    # the dual-stream MMDiT and the UViT build (held against the JAX
    # package in tests/test_torch_port_{mmdit,uvit}.py); the video model
    # takes the DiT only, as the JAX package's asserts
    from owl_audio_exps_tpu_torch.models.gamerft import GameRFTCore
    from owl_audio_exps_tpu_torch.nn.attn import UViT
    from owl_audio_exps_tpu_torch.nn.mmattn import MMDiT
    for backbone, cls in (("mmdit", MMDiT), ("uvit", UViT)):
        _, cfg = configs(backbone=backbone)
        assert isinstance(GameRFTAudioCore(cfg, device="cpu").transformer,
                          cls)
        cfg.model_id = "game_rft"
        with pytest.raises(NotImplementedError, match="JAX package"):
            GameRFTCore(cfg, device="cpu")
    assert get_core_cls("game_rft_audio") is GameRFTAudioCore
    assert get_core_cls("game_mft_audio").__name__ == "GameMFTAudioCore"
    with pytest.raises(ValueError):
        get_core_cls("no_such_model")
