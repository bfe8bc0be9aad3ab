"""The port's ring KV cache and its helpers (nn/kv_cache.py,
ops/masks.py ``decode_mask_from_cache``, ops/attention.py
``cached_dot_attention``, ops/rope.py ``rope_rebase_tables``) against the
JAX package, on the CPU in float32.

The same numpy-seeded writes go into a JAX ``KVCache`` and the port's,
and the ring state is compared after every operation: the counters
exactly, the ring contents (and int8 scales) to 1e-6. The port updates
its rings in place, the JAX package returns new ones. Masks are compared
exactly; the two-source attention to 1e-5 of the concatenated one; int8
quantization has equal scales and codes within 1 at rounding ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_audio_exps_tpu.configs import transformer_config as jax_config
from owl_audio_exps_tpu.models.audiorft import AudioRFTCore as JaxCore
from owl_audio_exps_tpu.nn import kv_cache as jkv
from owl_audio_exps_tpu.ops.attention import (
    cached_dot_attention as jax_cached_dot_attention)
from owl_audio_exps_tpu.ops.attention import dot_attention as jax_dot_attention
from owl_audio_exps_tpu.ops.masks import (
    decode_mask_from_cache as jax_decode_mask)
from owl_audio_exps_tpu.ops.rope import (rope_rebase_tables as
                                         jax_rebase_tables)
from owl_audio_exps_tpu_torch.configs import transformer_config as port_config
from owl_audio_exps_tpu_torch.models.audiorft import AudioRFTCore
from owl_audio_exps_tpu_torch.nn import kv_cache as pkv
from owl_audio_exps_tpu_torch.ops.attention import (cached_dot_attention,
                                                    dot_attention)
from owl_audio_exps_tpu_torch.ops.masks import decode_mask_from_cache
from owl_audio_exps_tpu_torch.ops.rope import (_table_frames, get_rope_freqs,
                                               rope_rebase_tables)

from torch_port_util import assert_same_state, cores, jax_apply, t

F32 = jnp.float32

# (create kwargs) of the rings under test: a single ring with a shadow
# mirror, one without (its trailing-window read takes slot by slot), a
# split local ring at 1 and at 2 tokens a frame, and an int8 split ring
GEOMETRIES = {
    "single_shadow": dict(n_layers=3, capacity=12, shadow=4),
    "single": dict(n_layers=2, capacity=10),
    "split": dict(n_layers=4, capacity=12, local_capacity=4,
                  local_flags=(False, True, True, False)),
    "split_tpf2": dict(n_layers=3, capacity=12, local_capacity=4,
                       tokens_per_frame=2, local_flags=(False, True, True)),
    "split_int8": dict(n_layers=3, capacity=12, local_capacity=4,
                       local_flags=(False, True, True), quant=True),
}


def _pair(geometry):
    kw = dict(batch_size=2, n_heads=2, head_dim=8, **GEOMETRIES[geometry])
    return (jkv.KVCache.create(dtype=F32, **kw),
            pkv.KVCache.create(dtype=torch.float32, device="cpu", **kw))


def assert_same_reads(jc, pc):
    """read_layer and gather_trailing of every layer, at every width the
    decoding local layers use."""
    tpf = jc.tokens_per_frame
    for i in range(jc.n_layers):
        for a, b in zip(jc.read_layer(i), pc.read_layer(i)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6,
                                       rtol=0)
        # the ring view of the layer's own ring (either, without a split)
        views = (False, True) if not jc.split else (jc.is_local_layer(i),)
        for local in views:
            for n in (tpf, 2 * tpf, 3 * tpf):
                want = jc.gather_trailing(i, n, local)
                got = pc.gather_trailing(i, n, local)
                np.testing.assert_allclose(got[0].numpy(),
                                           np.asarray(want[0]), atol=1e-6)
                np.testing.assert_allclose(got[1].numpy(),
                                           np.asarray(want[1]), atol=1e-6)
                np.testing.assert_array_equal(got[2].numpy(),
                                              np.asarray(want[2]))


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_ring_operations_match_jax(geometry):
    """Prefill (longer than the local ring), single-frame writes past the
    wrap (mirror upkeep), pop_oldest, drop_newest (rope_offset kept),
    reset and a new prefill: the state and every read after each one."""
    jc, pc = _pair(geometry)
    assert_same_state(jc, pc)
    tpf, L = jc.tokens_per_frame, jc.n_layers
    rs = np.random.RandomState(0)

    def write(jc, t):
        nk, nv = (rs.randn(L, 2, 2, t, 8).astype(np.float32) * 2
                  for _ in range(2))
        jc = jc.update_all(jnp.asarray(nk), jnp.asarray(nv)).advance(t)
        assert pc.update_all(torch.from_numpy(nk),
                             torch.from_numpy(nv)).advance(t) is pc
        return jc

    steps = [("write", 3 * tpf)] + [("write", tpf)] * 14 + [
        ("pop", 2), ("drop", 1), ("write", tpf), ("drop", 3),
        ("pop", 20), ("write", tpf), ("reset", 0), ("write", 4 * tpf),
        ("write", tpf)]
    for op, n in steps:
        if op == "write":
            jc = write(jc, n)
        elif op == "pop":
            jc = jc.pop_oldest(n)
            pc.pop_oldest(n)
        elif op == "drop":
            offset = int(pc.rope_offset)
            jc = jc.drop_newest(n)
            pc.drop_newest(n)
            assert int(pc.rope_offset) == offset     # never rewound
        else:
            jc = jc.reset()
            pc.reset()
        assert_same_state(jc, pc)
        assert_same_reads(jc, pc)
        np.testing.assert_array_equal(
            pc.slot_rel_idx().numpy(), np.asarray(jc.slot_rel_idx()))
        np.testing.assert_array_equal(
            pc.slot_rel_idx(local=True).numpy(),
            np.asarray(jc.slot_rel_idx(local=True)))
        np.testing.assert_array_equal(pc.write_positions(3).numpy(),
                                      np.asarray(jc.write_positions(3)))


def test_noise_on_read_with_given_draws():
    jc, pc = _pair("split")
    rs = np.random.RandomState(1)
    nk, nv = (rs.randn(4, 2, 2, 5, 8).astype(np.float32) for _ in range(2))
    jc = jc.update_all(jnp.asarray(nk), jnp.asarray(nv)).advance(5)
    pc.update_all(torch.from_numpy(nk), torch.from_numpy(nv)).advance(5)
    for layer in range(4):
        rng = jax.random.key(layer)
        jk, jv = jc.read_layer(layer, noise=0.3, rng=rng)
        rk, rv = jax.random.split(rng)
        shape = jk.shape
        draws = (t(jax.random.normal(rk, shape, F32)),
                 t(jax.random.normal(rv, shape, F32)))
        pk, pv = pc.read_layer(layer, noise=0.3, draws=draws)
        np.testing.assert_allclose(pk.numpy(), np.asarray(jk), atol=1e-6)
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=1e-6)
    # without draws the generator supplies them
    a = pc.read_layer(1, 0.3, torch.Generator().manual_seed(3))[0]
    b = pc.read_layer(1, 0.3, torch.Generator().manual_seed(3))[0]
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.equal(a, pc.read_layer(1)[0])


def test_from_config_takes_the_rings_jax_takes():
    """split_local_cache auto / true / false at the audio geometry (16 x 1
    window: split, local capacity 16, shadow 15, 4 global rings of 120
    slots with no shadow) and at a long video context (single ring with a
    shadow of one local span at a mid-size ring), int8 on request."""
    cases = [
        (dict(tokens_per_frame=1, local_window=16, n_layers=16), 120),
        (dict(tokens_per_frame=1, local_window=16, n_layers=16,
              split_local_cache=False), 120),
        (dict(tokens_per_frame=16, local_window=20, n_layers=4), 120),
        (dict(tokens_per_frame=16, local_window=4, n_layers=4,
              split_local_cache=True), 16),
        (dict(tokens_per_frame=16, local_window=4, n_layers=4), 400),
        (dict(tokens_per_frame=1, local_window=None, n_layers=3), 8),
        (dict(tokens_per_frame=1, local_window=4, n_layers=4,
              kv_quant="int8"), 16),
    ]
    for kw, frames in cases:
        base = dict(n_heads=2, d_model=32, n_frames=64, **kw)
        jc = jkv.KVCache.from_config(jax_config(**base), 1, frames, F32)
        pc = pkv.KVCache.from_config(port_config(**base), 1, frames,
                                     torch.float32, device="cpu")
        assert_same_state(jc, pc)
        assert (jc.split, jc.capacity, jc.local_capacity, jc.quantized) == \
            (pc.split, pc.capacity, pc.local_capacity, pc.quantized)
    audio = pkv.KVCache.from_config(port_config(
        n_layers=16, n_heads=16, d_model=1024, tokens_per_frame=1,
        local_window=16), 1, 120, torch.bfloat16, device="cpu")
    assert audio.split and tuple(audio.lk.shape) == (12, 1, 16, 31, 64)
    assert (audio.local_capacity, audio.lshadow) == (16, 15)
    assert tuple(audio.k.shape) == (4, 1, 16, 120, 64) and audio.shadow == 0


def test_writes_are_checked_and_fit_the_allocation():
    _, pc = _pair("single")
    with pytest.raises(ValueError, match="capacity"):
        pc.write_layer(0, torch.zeros(2, 2, 11, 8), torch.zeros(2, 2, 11, 8))
    _, p2 = _pair("split_tpf2")
    with pytest.raises(ValueError, match="frame-aligned"):
        p2.write_layer(0, torch.zeros(2, 2, 3, 8), torch.zeros(2, 2, 3, 8))
    # a 4-token write at slot 8 of a 10-slot ring overhangs; its start is
    # clamped to slot 6, as dynamic_update_slice clamps it
    jc, pc = _pair("single")
    rs = np.random.RandomState(2)
    for t_ in (8, 4):
        nk = rs.randn(2, 2, 2, t_, 8).astype(np.float32)
        jc = jc.update_all(jnp.asarray(nk), jnp.asarray(nk)).advance(t_)
        pc.update_all(torch.from_numpy(nk), torch.from_numpy(nk)).advance(t_)
        assert_same_state(jc, pc)


# ------------------------------------------------------------------ masks

@pytest.mark.parametrize("tpf,window,causal", [
    (1, None, True), (1, 4, True), (2, 3, True), (3, 2, False)])
@pytest.mark.parametrize("write_len", [0, 1, 2])
def test_decode_mask_matches_jax(tpf, window, causal, write_len):
    rs = np.random.RandomState(tpf + 7 * write_len)
    cap = 6 * tpf
    for _ in range(5):
        start = rs.randint(cap)
        length = rs.randint(cap + 1)
        slots = np.arange(cap + 2, dtype=np.int32)
        rel = np.where(slots < cap, (slots - start) % cap, cap).astype(
            np.int32)
        for q_len in (1, 2, 3):
            want = jax_decode_mask(jnp.asarray(rel), jnp.int32(length), q_len,
                                   tpf, window, causal, write_len=write_len,
                                   capacity=cap)
            got = decode_mask_from_cache(
                torch.from_numpy(rel), torch.tensor(length, dtype=torch.int32),
                q_len, tpf, window, causal, write_len=write_len, capacity=cap)
            assert got.dtype == torch.bool
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -------------------------------------------------------------- attention

def test_cached_dot_attention_equals_concat_and_jax():
    rs = np.random.RandomState(0)
    b, h, s, t_, dh = 2, 3, 24, 5, 16
    q, ck, cv = (rs.randn(b, h, n, dh).astype(np.float32)
                 for n in (t_, s, s))
    nk, nv = (rs.randn(b, h, t_, dh).astype(np.float32) for _ in range(2))
    mask = rs.rand(t_, s + t_) > 0.3
    mask[:, -1] = True
    ref = dot_attention(t(q), torch.cat([t(ck), t(nk)], 2),
                        torch.cat([t(cv), t(nv)], 2), t(mask))
    got = cached_dot_attention(t(q), t(ck), t(cv), t(nk), t(nv), t(mask))
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    want = jax_cached_dot_attention(*(jnp.asarray(a) for a in
                                      (q, ck, cv, nk, nv, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    want = jax_dot_attention(jnp.asarray(q),
                             jnp.concatenate([ck, nk], axis=2),
                             jnp.concatenate([cv, nv], axis=2),
                             jnp.asarray(mask))
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), atol=1e-5)


# ------------------------------------------------------------------- rope

@pytest.mark.parametrize("impl", ["ortho", "motion", "audio1d"])
def test_rebase_tables_and_shift_equivariance(impl):
    """The port's tables: every frame and slot moves by one constant angle
    (the property the rebase rests on), and the rebase tables equal the
    JAX package's."""
    kw = dict(n_layers=1, n_heads=4, d_model=64, sample_size=4,
              tokens_per_frame=17, n_frames=8, has_audio=True,
              rope_impl=impl, causal=True, rope_headroom=8)
    pcfg = port_config(**kw)
    angles = get_rope_freqs(pcfg)
    per = angles.shape[0] // _table_frames(pcfg)
    d = 3
    base = angles[d * per:(d + 1) * per] - angles[:per]
    for f in (1, 4, _table_frames(pcfg) - d - 1):
        diff = angles[(f + d) * per:(f + d + 1) * per] \
            - angles[f * per:(f + 1) * per]
        np.testing.assert_allclose(diff, base, rtol=1e-5, atol=1e-4)
    for got, want in zip(rope_rebase_tables(pcfg, d),
                         jax_rebase_tables(jax_config(**kw), d)):
        np.testing.assert_array_equal(got, want)


def test_rebase_plan_and_segments_match_jax():
    kw = dict(n_layers=1, n_heads=2, d_model=32, tokens_per_frame=1,
              n_frames=8, rope_impl="audio1d", has_audio=True,
              rope_headroom=8)
    for cap in (6, 16):
        want = jkv.rope_rebase_plan(jax_config(**kw), cap)
        got = pkv.rope_rebase_plan(port_config(**kw), cap)
        assert got[:2] == want[:2]
        for init, n in ((6, 10), (6, 40), (16, 40), (0, 3)):
            assert pkv.rope_rebase_segments(init, n, *got[:2]) == \
                jkv.rope_rebase_segments(init, n, *want[:2])
    table, delta, _ = pkv.rope_rebase_plan(port_config(**kw), 6)
    assert (table, delta) == (16, 9)
    segs = pkv.rope_rebase_segments(6, 40, table, delta)
    assert segs[0] == 10 and sum(segs) == 40


AUDIO = dict(model_id="audio_rft", n_layers=4, n_heads=2, d_model=32,
             channels=8, tokens_per_frame=1, n_frames=8, sample_size=8,
             causal=True, uncond=True, has_audio=True, rope_impl="audio1d",
             local_window=2, global_window=None, cfg_prob=0.0,
             backbone="dit", local_idx=2, rope_headroom=8)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_rebase_matches_jax_and_keeps_the_decode_output(kv_quant):
    """rebase_rope moves the rings as the JAX package's does, and a
    decoding forward against the rebased ring equals the one against the
    ring before it (relative positions are unchanged)."""
    jcfg, pcfg, jcore, params, port = cores(
        JaxCore, AudioRFTCore, AUDIO, ((1, 8, 8), (1, 8)), kv_quant=kv_quant)
    rs = np.random.RandomState(0)
    x = rs.randn(2, 7, 8).astype(np.float32)
    ts = rs.rand(2, 7).astype(np.float32)
    jc = jkv.KVCache.from_config(jcfg, 2, 6, F32)
    pc = pkv.KVCache.from_config(pcfg, 2, 6, torch.float32, device="cpu")
    _, jc = jax_apply(jcore, params, x[:, :6], ts[:, :6], kv_cache=jc,
                      write=True)
    with torch.no_grad():
        port(t(x[:, :6]), t(ts[:, :6]), kv_cache=pc, write=True)
        before = port(t(x[:, 6:]), t(ts[:, 6:]), kv_cache=pc, decoding=True)
    delta = 3
    jc = jc.rebase_rope(*jax_rebase_tables(jcfg, delta), delta)
    assert pc.rebase_rope(*rope_rebase_tables(pcfg, delta), delta) is pc
    assert int(pc.rope_offset) == 6 - delta
    assert_same_state(jc, pc)
    with torch.no_grad():
        after = port(t(x[:, 6:]), t(ts[:, 6:]), kv_cache=pc, decoding=True)
    want, _ = jax_apply(jcore, params, x[:, 6:], ts[:, 6:], kv_cache=jc,
                        decoding=True)
    np.testing.assert_allclose(after.numpy(), np.asarray(want), atol=1e-5)
    if kv_quant is None:
        torch.testing.assert_close(after, before, atol=1e-5, rtol=0)


# ------------------------------------------------------------------- int8

def test_quantize_kv_matches_jax():
    rs = np.random.RandomState(4)
    x = (rs.randn(3, 2, 7, 16) * np.array([1e-3, 1.0, 40.0])[:, None, None,
                                                               None])
    x = x.astype(np.float32)
    x[0, 0, 0] = 0.0
    for scale_dtype in (jnp.bfloat16, F32):
        jq, js = jkv._quantize_kv(jnp.asarray(x), scale_dtype)
        pq, ps = pkv._quantize_kv(t(x), torch.bfloat16
                                  if scale_dtype == jnp.bfloat16
                                  else torch.float32)
        assert pq.dtype == torch.int8 and ps.shape == (3, 2, 7, 1)
        np.testing.assert_array_equal(ps.float().numpy(),
                                      np.asarray(js, np.float32))
        diff = np.abs(pq.numpy().astype(int) - np.asarray(jq).astype(int))
        assert diff.max() <= 1      # a rounding tie may go either way
        np.testing.assert_array_equal(
            pkv._dequantize_kv(pq, ps).float().numpy(),
            np.asarray(jkv._dequantize_kv(jnp.asarray(pq.numpy()), js),
                       np.float32))


def _roundtrip_err(orig, deq):
    amax = np.abs(orig).max(axis=-1, keepdims=True)
    return (np.abs(deq - orig) / np.maximum(amax, 1e-8)).max()


def test_quantized_ring_mechanics():
    """The int8 ring tracks its float twin: counters exactly, the valid
    window within the int8 step (the bound of tests/test_kv_quant.py),
    the trailing-window read through the mirror too."""
    kw = dict(n_layers=2, batch_size=1, capacity=12, n_heads=2, head_dim=8,
              tokens_per_frame=1, shadow=4, device="cpu",
              dtype=torch.float32)
    ref = pkv.KVCache.create(**kw)
    qnt = pkv.KVCache.create(**kw, quant=True)
    assert qnt.quantized and qnt.k.dtype == torch.int8
    rs = np.random.RandomState(2)
    for _ in range(15):
        nk = torch.from_numpy(rs.randn(2, 1, 2, 1, 8).astype(np.float32))
        nv = torch.from_numpy(rs.randn(2, 1, 2, 1, 8).astype(np.float32))
        ref.update_all(nk, nv).advance(1)
        qnt.update_all(nk, nv).advance(1)
    ref.pop_oldest(2).drop_newest(1)
    qnt.pop_oldest(2).drop_newest(1)
    for name in ("start", "length", "rope_offset"):
        assert int(getattr(ref, name)) == int(getattr(qnt, name))
    valid = (ref.slot_rel_idx() < ref.length).numpy()
    for a, b in zip(ref.read_layer(0), qnt.read_layer(0)):
        assert _roundtrip_err(a.numpy()[:, :, valid],
                              b.numpy()[:, :, valid]) < 0.006
    rk, rv, rvalid = ref.gather_trailing(1, 4, local=False)
    qk, qv, qvalid = qnt.gather_trailing(1, 4, local=False)
    torch.testing.assert_close(rvalid, qvalid, atol=0, rtol=0)
    assert _roundtrip_err(rk.numpy(), qk.numpy()) < 0.006
    assert _roundtrip_err(rv.numpy(), qv.numpy()) < 0.006
