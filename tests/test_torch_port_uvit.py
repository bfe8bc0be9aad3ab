"""The port's UViT backbone (nn/attn.py ``UViT``, ``SkipConnection``) in
the AV model against the JAX package, on the CPU in float32, at
tests/test_models.py's and tests/test_remaining.py's sizes.

JAX params are carried across with ``params_from_jax`` (strict); inputs
are numpy from a seed; the noise is the JAX model's own draw. The JAX
package takes its dense path on the CPU, the port its dense path or K1's
route (``attn_impl: splash``, the plain version on CPU tensors).
Tolerances: forwards atol 1e-4; the cached forward against the uncached
one atol 2e-4 (the JAX test's); ring contents atol 1e-4, counters exact;
losses rtol 1e-5, gradients atol 1e-5 / rtol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_audio_exps_tpu.models.gamerft_audio import \
    GameRFTAudio as JaxGameRFTAudio
from owl_audio_exps_tpu.models.gamerft_audio import \
    GameRFTAudioCore as JaxCore
from owl_audio_exps_tpu.nn.kv_cache import KVCache as JaxKVCache
from owl_audio_exps_tpu_torch.models.gamerft_audio import (GameRFTAudio,
                                                           GameRFTAudioCore)
from owl_audio_exps_tpu_torch.nn.attn import (UViT,
                                              attention_forwards_per_step)
from owl_audio_exps_tpu_torch.nn.kv_cache import KVCache
from owl_audio_exps_tpu_torch.ops import splash
from owl_audio_exps_tpu_torch.utils.weights import params_from_jax

from torch_port_util import (AV_SHAPES, MODEL_RNGS, TINY_AV,
                             assert_same_state, av_inputs, carried, configs,
                             cores, jax_apply, jax_core, numpy_params, t)


UVIT = dict(TINY_AV, backbone="uvit", n_layers=4, causal=True, n_buttons=3)


@pytest.mark.parametrize("attn_impl", ["auto", "splash"])
@pytest.mark.parametrize("n_layers", [3, 4])
def test_uvit_core_matches_jax(n_layers, attn_impl):
    """Every block global, the skips joined in reverse order: the core
    against the JAX core, atol 1e-4; on K1's route every block calls K1
    with the global window."""
    jcfg, pcfg, jcore, params, port = cores(
        JaxCore, GameRFTAudioCore, UVIT, AV_SHAPES, n_layers=n_layers)
    pcfg.attn_impl = attn_impl
    assert isinstance(port.transformer, UViT)
    assert len(port.transformer.skip_projs) == n_layers - n_layers // 2 - 1
    inputs = av_inputs(np.random.RandomState(0), 2, 4, jcfg)
    (vj, aj), _ = jax_apply(jcore, params, *inputs)
    windows = []
    orig = splash.splash_attention
    splash.splash_attention = lambda *a, **kw: (windows.append(a[4]),
                                                orig(*a, **kw))[1]
    try:
        with torch.no_grad():
            vp, ap = port(*(t(a) for a in inputs))
    finally:
        splash.splash_attention = orig
    assert windows == ([None] * n_layers if attn_impl == "splash" else [])
    np.testing.assert_allclose(vp.numpy(), np.asarray(vj), atol=1e-4, rtol=0)
    np.testing.assert_allclose(ap.numpy(), np.asarray(aj), atol=1e-4, rtol=0)


@pytest.mark.parametrize("decoding", [False, True])
def test_uvit_kv_cache_matches_jax_and_the_uncached_forward(decoding):
    """tests/test_models.py::test_uvit_kv_cache_equivalence on the port:
    the context written, then the last frame against the ring equals the
    uncached forward's last frame (atol 2e-4); velocities and ring state
    against the JAX package's."""
    jcfg, pcfg, jcore, params, port = cores(JaxCore, GameRFTAudioCore,
                                             UVIT, AV_SHAPES)
    rs = np.random.RandomState(11)
    n = 6
    inputs = av_inputs(rs, 1, n, jcfg)
    args = [t(a) for a in inputs]
    with torch.no_grad():
        fv, fa = port(*args)
    jc = JaxKVCache.from_config(jcfg, 1, dtype=jnp.float32)
    _, jc = jax_apply(jcore, params, *(a[:, :n - 1] for a in inputs),
                      kv_cache=jc, write=True)
    (jv, ja), _ = jax_apply(jcore, params, *(a[:, n - 1:] for a in inputs),
                            kv_cache=jc, decoding=decoding)
    pc = KVCache.from_config(pcfg, 1, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        port(*(a[:, :n - 1] for a in args), kv_cache=pc, write=True)
        assert int(pc.length) == (n - 1) * pcfg.tokens_per_frame
        assert_same_state(jc, pc, atol=1e-4)
        lv, la = port(*(a[:, n - 1:] for a in args), kv_cache=pc,
                      decoding=decoding)
    torch.testing.assert_close(lv[:, 0], fv[:, -1], atol=2e-4, rtol=0)
    torch.testing.assert_close(la[:, 0], fa[:, -1], atol=2e-4, rtol=0)
    np.testing.assert_allclose(lv.numpy(), np.asarray(jv), atol=1e-4, rtol=0)
    np.testing.assert_allclose(la.numpy(), np.asarray(ja), atol=1e-4, rtol=0)


def test_uvit_fused_write_commits_the_leading_frame():
    """The UViT takes write_len (unlike the MMDiT): a 2-frame forward with
    write_len=1 commits one frame, ring for ring with the JAX package."""
    jcfg, pcfg, jcore, params, port = cores(JaxCore, GameRFTAudioCore,
                                             UVIT, AV_SHAPES)
    inputs = av_inputs(np.random.RandomState(12), 1, 5, jcfg)
    jc = JaxKVCache.from_config(jcfg, 1, dtype=jnp.float32)
    pc = KVCache.from_config(pcfg, 1, dtype=torch.float32, device="cpu")
    head = [a[:, :3] for a in inputs]
    two = [a[:, 3:5] for a in inputs]
    _, jc = jax_apply(jcore, params, *head, kv_cache=jc, write=True)
    (jv, ja), jc = jax_apply(jcore, params, *two, kv_cache=jc, write=True,
                             write_len=1)
    with torch.no_grad():
        port(*(t(a) for a in head), kv_cache=pc, write=True)
        pv, pa = port(*(t(a) for a in two), kv_cache=pc, write=True,
                      write_len=1)
    assert int(pc.length) == 4 * pcfg.tokens_per_frame
    assert_same_state(jc, pc, atol=1e-4)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=1e-4, rtol=0)
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), atol=1e-4, rtol=0)


@pytest.mark.parametrize("remat", [False, True])
def test_uvit_backbone_loss_and_gradients_match_jax(remat):
    """tests/test_remaining.py::test_uvit_backbone on the port (3 layers,
    bidirectional, uncond, one skip projection): return_dict's loss and
    predictions on the JAX model's draws (rtol 1e-5, atol 1e-5) and every
    gradient (atol 1e-5, rtol 1e-3), plain and under block remat (2
    attention forwards a layer)."""
    over = dict(n_layers=3, causal=False, uncond=True, local_window=None,
                cfg_prob=0.0, gradient_checkpointing=remat)
    jcfg, pcfg = configs(**dict(dict(backbone="uvit", n_buttons=3), **over))
    rs = np.random.RandomState(0)
    x = rs.randn(1, 4, 4, 2, 2).astype(np.float32)
    audio = rs.randn(1, 4, 4).astype(np.float32)
    model, params = jax_core(JaxGameRFTAudio, jcfg, x, audio,
                             rngs=MODEL_RNGS)

    def loss_and_draw(p):
        out = model.apply(p, jnp.asarray(x), jnp.asarray(audio),
                          return_dict=True, rngs={"noise": jax.random.key(2)})
        return out["diffusion_loss"], out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss_and_draw, has_aux=True))(params)
    pcfg.attn_impl = "splash"
    port = carried(GameRFTAudio, pcfg, params)
    assert "core.transformer.skip_projs.0.proj.weight" in \
        dict(port.named_parameters())
    calls = []
    orig = splash.splash_attention
    splash.splash_attention = lambda *a, **kw: (calls.append(1),
                                                orig(*a, **kw))[1]
    try:
        got = port(t(x), t(audio), ts=t(out["ts"]), z_video=t(out["z_video"]),
                   z_audio=t(out["z_audio"]),
                   has_controls=t(out["cfg_mask"]), return_dict=True)
        got["diffusion_loss"].backward()
    finally:
        splash.splash_attention = orig
    assert len(calls) == sum(attention_forwards_per_step(pcfg)) == \
        3 * (2 if remat else 1)
    for key in ("diffusion_loss", "video_loss", "audio_loss", "pred_video",
                "pred_audio"):
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(out[key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    want = params_from_jax(numpy_params(grads), jcfg.n_heads)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=1e-3, err_msg=name)
