"""The decode attention's algorithm (ops/decode_attention.py, the plain
version of csrc/decode_attention.cu) against ``dot_attention`` and
``cached_dot_attention`` (the port's) and the JAX package's
``dot_attention``, over rings and masks made as the cached forward makes
them (nn/kv_cache.py, nn/attn.py ``build_masks``); and the route
``cached_attention`` takes (kernel or dense, ``dense_calls``).

Inputs are numpy draws from a seed. In float32 the plain version differs
from dense attention only in the order of its sums (the softmax sum a
split at a time, the splits' P.V parts), so it is held at 1e-5 absolute
(outputs are O(1)). In bf16 both round P to bf16 before P.V, and a sum
taken in another order can move a probability across a bf16 rounding
boundary: that moves an output by about one bf16 step of a product, so
the bound is 8e-3 on the largest and 2e-4 on the mean absolute error.

The kernel itself runs only on a card: tests/test_torch_port_kernels.py
holds it against this plain version (``cuda`` marker).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from owl_audio_exps_tpu.ops.attention import dot_attention as jax_dot_attention
from owl_audio_exps_tpu_torch.configs import transformer_config
from owl_audio_exps_tpu_torch.nn import attn as port_attn
from owl_audio_exps_tpu_torch.nn.attn import build_masks, cached_attention
from owl_audio_exps_tpu_torch.nn.kv_cache import KVCache
from owl_audio_exps_tpu_torch.ops import decode_attention as da
from owl_audio_exps_tpu_torch.ops.attention import (cached_dot_attention,
                                                    dot_attention)

F32_ATOL = 1e-5
BF16_MAX, BF16_MEAN = 8e-3, 2e-4
TPF = 65          # the AV model's tokens a frame
CAP_FRAMES = 8    # a ring of 520 slots: 9 tiles of 64 (11 with the shadow)
LOCAL_W = 2       # frames: a shadow of 130 slots on the single ring


def _cfg(**kw):
    return transformer_config(tokens_per_frame=TPF, local_window=LOCAL_W,
                              global_window=None, causal=True,
                              n_frames=CAP_FRAMES, **kw)


def _ring(B, H, Dh, length, start, seed, dtype=torch.float32, quant=False):
    """A single ring with its shadow, every slot (shadow and invalid ones
    too) filled with draws, at ``length`` tokens from slot ``start``."""
    rs = np.random.RandomState(seed)
    c = KVCache.create(n_layers=2, batch_size=B, capacity=CAP_FRAMES * TPF,
                       n_heads=H, head_dim=Dh, tokens_per_frame=TPF,
                       dtype=dtype, shadow=LOCAL_W * TPF, quant=quant)
    for buf in (c.k, c.v):
        buf.copy_(torch.from_numpy(rs.randn(*buf.shape).astype(np.float32)))
    c.start.fill_(start)
    c.length.fill_(length)
    c.rope_offset.fill_(length)
    return c


def _case(kind, B, H, Dh, lq, length, start, write_len=None, seed=0):
    """(q, ring k, ring v, new k, new v, mask) of one call of the cached
    forward, float32. ``kind``: global or local (a forward with or without
    the fused write's ``write_len``), decode_global, or gathered (a
    decoding local layer's trailing window)."""
    cfg = _cfg()
    c = _ring(B, H, Dh, length, start, seed)
    rs = np.random.RandomState(seed + 1)
    q, nk, nv = (torch.from_numpy(rs.randn(B, H, lq, Dh).astype(np.float32))
                 for _ in range(3))
    if kind == "gathered":
        n_gather = LOCAL_W * TPF - lq
        ck, cv, valid = c.gather_trailing(1, n_gather, local=True)
        mask = torch.cat([valid, torch.ones(lq, dtype=torch.bool)])[None, :]
        return q, ck, cv, nk, nv, mask
    local, glob = build_masks(cfg, lq, None, kv_cache=c,
                              decoding=kind == "decode_global",
                              write_len=write_len)
    ck, cv = c.read_layer(0)
    return q, ck, cv, nk, nv, local if kind == "local" else glob


RING_CASES = {
    # ring state, mask kind, B, H, Dh, lq, length, start, write_len
    "empty_fused_write": ("global", 1, 24, 64, 130, 0, 0, 65),
    "partial": ("global", 1, 24, 64, 65, 3 * TPF, 0, None),
    "full_wrapped_fused_evicting": ("global", 1, 24, 64, 130, 520, 195, 65),
    "full_local_window_over_ring": ("local", 1, 24, 64, 130, 520, 195, 65),
    "decode_wrapped_b8_h12": ("decode_global", 8, 12, 64, 65, 520, 325,
                              None),
    "gathered_window_b8_dh128": ("gathered", 8, 12, 128, 65, 520, 325, None),
    "gathered_partial": ("gathered", 1, 24, 64, 65, 40, 0, None),
    "prime_global": ("global", 1, 2, 64, 7 * TPF, 0, 0, None),
    "prime_local": ("local", 1, 2, 64, 7 * TPF, 0, 0, None),
    "partial_dh128": ("global", 1, 12, 128, 130, 5 * TPF, 390, 65),
    "full_b8": ("global", 8, 24, 64, 130, 520, 0, 65),
}


@pytest.mark.parametrize("name", list(RING_CASES))
def test_plain_matches_dense_and_jax(name):
    kind, B, H, Dh, lq, length, start, wl = RING_CASES[name]
    q, ck, cv, nk, nv, mask = _case(kind, B, H, Dh, lq, length, start, wl)
    # every row sees its own frame: no row is left without a key
    assert bool(mask.any(-1).all())
    S = ck.shape[2]
    got = da.decode_attention_plain(q, ck, cv, nk, nv, mask)
    ref = dot_attention(q, torch.cat([ck, nk], 2), torch.cat([cv, nv], 2),
                        mask)
    torch.testing.assert_close(got, ref, atol=F32_ATOL, rtol=0)
    two = cached_dot_attention(q, ck, cv, nk, nv, mask)
    torch.testing.assert_close(got, two, atol=F32_ATOL, rtol=0)
    jm = mask.numpy() if mask.ndim == 2 else mask.numpy()[:, None]
    want = jax_dot_attention(jnp.asarray(q.numpy()),
                             jnp.asarray(torch.cat([ck, nk], 2).numpy()),
                             jnp.asarray(torch.cat([cv, nv], 2).numpy()),
                             jnp.asarray(jm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=F32_ATOL, rtol=0)
    # the tiles: the ring's first, the shadow's all-false ones skipped
    nr, T = da.key_tiles(S, nk.shape[2])
    assert nr == -(-S // 64) and T == nr + -(-lq // 64)
    # bf16 through the wrapper (the plain version on the CPU)
    bf = [x.to(torch.bfloat16) for x in (q, ck, cv, nk, nv)]
    got16 = da.decode_attention(*bf, mask)
    ref16 = dot_attention(bf[0], torch.cat([bf[1], bf[3]], 2),
                          torch.cat([bf[2], bf[4]], 2), mask)
    assert got16.dtype == torch.bfloat16 and got16.shape == (B, H, lq, Dh)
    err = (got16.float() - ref16.float()).abs()
    assert err.max().item() < BF16_MAX and err.mean().item() < BF16_MEAN


def test_per_batch_mask_matches_dense():
    """A mask with its own rows per batch row, [b, lq, S + t]."""
    rs = np.random.RandomState(3)
    B, H, lq, S, t_, Dh = 3, 2, 70, 300, 70, 64
    q, nk, nv = (torch.from_numpy(rs.randn(B, H, lq, Dh).astype(np.float32))
                 for _ in range(3))
    ck, cv = (torch.from_numpy(rs.randn(B, H, S, Dh).astype(np.float32))
              for _ in range(2))
    mask = torch.from_numpy(rs.rand(B, lq, S + t_) > 0.6)
    mask[1, :, :128] = False       # whole tiles hidden for one batch row
    mask[..., -1] = True
    got = da._plain(q, ck, cv, nk, nv, mask, 3)
    ref = dot_attention(q, torch.cat([ck, nk], 2), torch.cat([cv, nv], 2),
                        mask)
    torch.testing.assert_close(got, ref, atol=F32_ATOL, rtol=0)


def test_geometry_of_the_serve_shapes():
    """The tiling the kernel takes at the serve's shapes (PERF.md): 65 and
    130 query rows in one block of 80 and 144 rows; a prime of 7,735 rows
    in 49 blocks of 160; the ring's 8,840 slots in 139 tiles."""
    assert da.query_tiling(65) == (80, 1)
    assert da.query_tiling(130) == (144, 1)
    assert da.query_tiling(7735) == (160, 49)
    assert da.key_tiles(8840, 130) == (139, 142)
    assert da.key_tiles(975, 65) == (16, 18)
    assert da.tile_columns(138, 8840, 130) == (8832, 8840)
    assert da.tile_columns(139, 8840, 130) == (8840, 8904)
    assert da.tile_columns(141, 8840, 130) == (8968, 8970)
    # 24 heads of one session: about two blocks an SM
    assert da.split_count(24, 142) == 11
    assert da.split_count(24 * 49, 260) == 1
    assert da.split_count(24, 5) == 5
    assert [da.split_range(s, 3, 10) for s in range(3)] == [
        (0, 3), (3, 6), (6, 10)]


@settings(max_examples=30, deadline=None)
@given(B=st.integers(1, 2), H=st.integers(1, 2), lq=st.integers(1, 170),
       S=st.integers(0, 330), t_=st.integers(1, 90), splits=st.integers(1, 6),
       dead=st.lists(st.integers(0, 10), max_size=5),
       p=st.floats(0.05, 1.0), seed=st.integers(0, 2 ** 31 - 1))
def test_hidden_tiles_contribute_nothing_and_splits_sum_in_order(
        B, H, lq, S, t_, splits, dead, p, seed):
    """A tile whose mask block is all false is never read: K/V of NaN there
    leave the output as it is, bit for bit. The output is the splits'
    parts summed in split order, bit for bit, and runs repeat."""
    rs = np.random.RandomState(seed % (2 ** 32))
    Dh = 64
    q, nk, nv = (torch.from_numpy(rs.randn(B, H, n, Dh).astype(np.float32))
                 for n in (lq, t_, t_))
    ck, cv = (torch.from_numpy(rs.randn(B, H, S, Dh).astype(np.float32))
              for _ in range(2))
    mask = torch.from_numpy(rs.rand(lq, S + t_) < p)
    nr, T = da.key_tiles(S, t_)
    splits = min(splits, T)
    poisoned = [x.clone() for x in (ck, cv, nk, nv)]
    for j in {d % T for d in dead}:
        c0, c1 = da.tile_columns(j, S, t_)
        mask[:, c0:c1] = False
        for ring, new in ((poisoned[0], poisoned[2]),
                          (poisoned[1], poisoned[3])):
            if j < nr:
                ring[:, :, c0:c1] = math.nan
            else:
                new[:, :, c0 - S:c1 - S] = math.nan
    parts = []
    clean = da._plain(q, ck, cv, nk, nv, mask, splits, partials=parts)
    dirty = da._plain(q, *poisoned, mask, splits)
    again = da._plain(q, ck, cv, nk, nv, mask, splits)
    assert torch.isfinite(clean).all()
    assert torch.equal(clean, dirty) and torch.equal(clean, again)
    rows, nq = da.query_tiling(lq)
    assert len(parts) <= nq
    for qt, split_parts in enumerate(parts):
        acc = None
        for o in split_parts:
            if o is not None:
                acc = o if acc is None else acc + o
        r0 = qt * rows
        assert torch.equal(clean[:, :, r0:r0 + acc.shape[2]], acc)
    # rows that see no key are zero
    blind = ~mask.any(-1)
    assert torch.equal(clean[:, :, blind], torch.zeros_like(
        clean[:, :, blind]))
    # another split count: the same function, the sums in another order
    other = da._plain(q, ck, cv, nk, nv, mask, max(1, splits - 1))
    torch.testing.assert_close(other, clean, atol=F32_ATOL, rtol=0)


# ---------------------------------------------------------------- routing

@pytest.fixture
def spy(monkeypatch):
    """``accepts`` as on a card (the CPU tensors' refusals, less the
    device), and a record of the calls that reach the launch, which runs
    the plain version."""
    calls = []

    def launch(*a):
        calls.append(a[0].shape)
        return da.decode_attention_plain(*a)

    monkeypatch.setattr(da, "accepts", lambda *a: da.refusal(*a) is None)
    monkeypatch.setattr(da, "decode_attention_cuda", launch)
    return calls


def _route(impl="auto", concat="concat", quant=False, grad=False, seed=0):
    """One cached_attention call of a decoding global layer, bf16."""
    cfg = _cfg(decode_impl=impl, cache_attn_impl=concat)
    c = _ring(1, 2, 64, 3 * TPF, 0, seed, dtype=torch.bfloat16, quant=quant)
    rs = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rs.randn(1, 2, TPF, 64).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    if grad:
        q.requires_grad_()
    _, glob = build_masks(cfg, TPF, None, kv_cache=c, decoding=True)
    before = port_attn.dense_calls
    out = cached_attention(cfg, 0, False, q, k, v, glob, c)
    ck, cv = c.read_layer(0)
    ref = dot_attention(q.detach(), torch.cat([ck.to(q.dtype), k], 2),
                        torch.cat([cv.to(q.dtype), v], 2), glob)
    return out, ref, port_attn.dense_calls - before


def test_route_auto_takes_the_kernel_where_it_can(spy):
    out, ref, dense = _route("auto")
    assert len(spy) == 1 and dense == 0
    err = (out.float() - ref.float()).abs()
    assert err.max().item() < BF16_MAX and err.mean().item() < BF16_MEAN


@pytest.mark.parametrize("path,kw", [
    ("decode_impl dense: dot_attention", dict(impl="dense")),
    ("decode_impl dense, noconcat: cached_dot_attention",
     dict(impl="dense", concat="noconcat")),
    ("int8 ring: its dequantising dense path", dict(quant=True)),
    ("a gradient is required: dot_attention", dict(grad=True)),
])
def test_route_dense(spy, path, kw):
    out, ref, dense = _route(**kw)
    assert spy == [] and dense == 1, path
    if not kw.get("quant"):
        torch.testing.assert_close(out.detach(), ref, atol=0, rtol=0)


def test_route_on_the_cpu_is_dense():
    """Without a card every call is dense, as before the kernel."""
    out, ref, dense = _route("auto")
    assert dense == 1
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


def _args(B=1, H=2, lq=5, S=70, t_=5, Dh=64, dtype=torch.bfloat16,
          device="cpu"):
    def z(n):
        return torch.zeros(B, H, n, Dh, dtype=dtype, device=device)
    return [z(lq), z(S), z(S), z(t_), z(t_)]


def _mask(device="cpu", width=75):
    return torch.ones(5, width, dtype=torch.bool, device=device)


@pytest.mark.parametrize("why,args,mask,match", [
    ("float32 operands", _args(dtype=torch.float32), _mask(),
     "share one of"),
    ("an int8 ring", _args()[:1] + [torch.zeros(1, 2, 70, 64,
                                                dtype=torch.int8)] * 2
     + _args()[3:], _mask(), "share one of"),
    ("head dim 96", _args(Dh=96), _mask(), "head dim 96"),
    ("no mask", _args(), None, "mask must be bool"),
    ("a float mask", _args(), torch.ones(5, 75), "mask must be bool"),
    ("a mask of another width", _args(), _mask(width=74),
     "does not broadcast"),
    ("a device with no kernel", _args(device="meta"), _mask("meta"),
     "no decode attention for device meta"),
])
def test_wrapper_refuses_and_never_falls_back(why, args, mask, match):
    assert not da.accepts(*args, mask), why
    with pytest.raises(ValueError, match=match):
        da.decode_attention(*args, mask)


def test_wrapper_refuses_a_gradient():
    args = _args()
    args[0].requires_grad_()
    with pytest.raises(ValueError, match="gradient"):
        da.decode_attention(*args, _mask())
    with torch.no_grad():
        da.decode_attention(*args, _mask())    # no gradient asked: taken


def test_serve_through_the_kernel_route_matches_dense(spy):
    """The cached AV serve (prime and steady ticks) on the CPU with every
    attention call routed as on a card, through the plain version,
    against the dense route: 2 forwards x 2 layers a steady tick take the
    kernel's launch and none is dense."""
    from owl_audio_exps_tpu_torch.inference.pipeline import (
        AVCachedStreamingPipeline)
    from owl_audio_exps_tpu_torch.models.gamerft_audio import (
        GameRFTAudioCore)
    cfg = transformer_config(
        model_id="game_rft_audio", n_layers=2, n_heads=2, d_model=128,
        channels=8, audio_channels=4, sample_size=2, tokens_per_frame=5,
        n_frames=8, rope_headroom=8, n_buttons=3, causal=True,
        has_audio=True, local_window=2, global_window=None, local_idx=2)
    core = GameRFTAudioCore(cfg, dtype=torch.bfloat16, device="cpu",
                            seed=0).to(torch.bfloat16)
    g = torch.Generator().manual_seed(1)
    ctx = (torch.randn(1, 3, 8, 2, 2, generator=g),
           torch.randn(1, 3, 4, generator=g), torch.zeros(1, 3, 2),
           torch.zeros(1, 3, 3))
    rs = np.random.RandomState(0)
    ticks = [(rs.randn(2).astype(np.float32),
              (rs.rand(3) > 0.5).astype(np.float32)) for _ in range(8)]

    def serve(routed):
        pipe = AVCachedStreamingPipeline(core, cfg, window_frames=6,
                                         sampling_steps=2, seed=4,
                                         device="cpu")
        pipe.prime(*ctx)
        outs, counts = [], []
        for mouse, btn in ticks:
            n0, d0 = len(spy), port_attn.dense_calls
            frame, audio, _ = pipe(mouse, btn)
            outs.append((frame, audio))
            counts.append((len(spy) - n0, port_attn.dense_calls - d0))
        return outs, counts

    routed, counts = serve(True)
    # the prime pends its last frame: every tick is steady
    assert all(c == (4, 0) for c in counts)
    da_accepts = da.accepts
    da.accepts = lambda *a: False           # the dense route
    try:
        dense, dcounts = serve(False)
    finally:
        da.accepts = da_accepts
    assert all(c[0] == 0 for c in dcounts)
    for (f, a), (fd, ad) in zip(routed, dense):
        assert torch.isfinite(f.float()).all()
        for got, want in ((f, fd), (a, ad)):
            assert (got.float() - want.float()).abs().max().item() < 5e-2
