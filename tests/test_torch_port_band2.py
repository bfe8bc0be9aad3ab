"""The port's band2 attention (owl_audio_exps_tpu_torch/ops/band2.py, K5)
and its routing against the JAX package, on the CPU.

On the CPU ``band2_attention`` runs its plain version, and autograd over
it is the plain backward; the JAX side runs its Pallas kernel in
interpret mode (``band2_attention(..., interpret=True)``, its custom vjp
under ``jax.vjp``), as tests/test_band2.py runs it. Both in float32 on the
same numpy inputs; tolerance 2e-5 (atol and rtol) on the output and the
gradients, float32 reassociation between the dense and the chunked sums.

The CUDA kernel runs only on a card: tests/test_torch_port_kernels.py
holds it against the plain version there. What the kernel computes
around its tiles is modelled in Python here (tests/torch_port_util.py
``kv_range``, ``q_range``, ``tile_full``, the arithmetic of
csrc/hopper_attention.cuh) and held to the dense mask, so every visible
pair is walked exactly once by the forward, dq and dkv kernels, and to
the plan, whose refs hold every visible pair.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_audio_exps_tpu.configs import transformer_config as jax_config
from owl_audio_exps_tpu.nn import attn as jax_attn
from owl_audio_exps_tpu.ops import band as jax_band_mod
from owl_audio_exps_tpu.ops import band2 as jax_band2
from owl_audio_exps_tpu.ops import local as jax_local
from owl_audio_exps_tpu.ops import splash as jax_splash
from owl_audio_exps_tpu_torch.configs import transformer_config
from owl_audio_exps_tpu_torch.nn.attn import attention_route, train_attention
from owl_audio_exps_tpu_torch.ops import band, band2, splash
from owl_audio_exps_tpu_torch.ops.masks import dense_mask

import torch_port_util as walk

TOL = 2e-5
SHIFT = 8.0   # sqrt(Dh): exact under QK rms-norm


def _arrays(rs, n, shape, normed=False):
    out = [rs.randn(*shape).astype(np.float32) for _ in range(n)]
    if normed:  # unit-RMS q and k, as the attention module's rms_norm
        for i in (0, 1):
            out[i] = out[i] / np.sqrt(np.mean(out[i] ** 2, -1, keepdims=True)
                                      + 1e-6)
    return out


def _jax_out_and_grads(fn, q, k, v, g):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _port_out_and_grads(fn, q, k, v, g):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fn(*ts)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _assert_close(got, want, what):
    out_p, grads_p = got
    out_j, grads_j = want
    np.testing.assert_allclose(out_p, out_j, atol=TOL, rtol=TOL,
                               err_msg=f"{what} out")
    for name, a, b in zip(("dq", "dk", "dv"), grads_p, grads_j):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL,
                                   err_msg=f"{what} {name}")


# the cases of tests/test_band2.py:26-34: tpf, window, span, m, n_chunks
CASES = [(16, 4, 32, 2, 6), (16, 8, 32, 4, 8), (16, 8, 64, 2, 5),
         (8, 4, 16, 2, 12), (65, 8, 192, 3, 5), (65, 4, 96, 3, 6)]


@pytest.mark.parametrize("bound", [None, SHIFT], ids=["rowmax", "shift8"])
@pytest.mark.parametrize("tpf,window,span,m,n_chunks", CASES)
def test_band2_matches_jax_band2(tpf, window, span, m, n_chunks, bound):
    """Forward and gradients on every plan of the JAX package's tests,
    aligned and ragged (NEXT ref), under both softmax forms."""
    L = span * n_chunks
    rs = np.random.RandomState(0)
    q, k, v, g = _arrays(rs, 4, (1, 2, L, 64), normed=bound is not None)
    want = _jax_out_and_grads(lambda q, k, v: jax_band2.band2_attention(
        q, k, v, tpf, window, span, m, interpret=True, logit_bound=bound),
        q, k, v, g)
    before = (band2.fwd_launches, band2.bwd_launches)
    got = _port_out_and_grads(lambda *a: band2.band2_attention(
        *a, tpf, window, span, m, logit_bound=bound), q, k, v, g)
    assert (band2.fwd_launches, band2.bwd_launches) == before  # CPU: plain
    _assert_close(got, want, f"plan ({span}, {m}) tpf {tpf}")


def test_band2_head_chunks_and_batch_match_jax():
    """B = 2 and head_chunks = 2 on a ragged plan (65, 4, 96, 3) and the
    fixed shift, against the JAX kernel called the same way."""
    tpf, window, span, m = 65, 4, 96, 3
    L = span * 6
    rs = np.random.RandomState(5)
    q, k, v, g = _arrays(rs, 4, (2, 4, L, 64), normed=True)
    want = _jax_out_and_grads(lambda q, k, v: jax_band2.band2_attention(
        q, k, v, tpf, window, span, m, head_chunks=2, interpret=True,
        logit_bound=SHIFT), q, k, v, g)
    got = _port_out_and_grads(lambda *a: band2.band2_attention(
        *a, tpf, window, span, m, head_chunks=2, logit_bound=SHIFT),
        q, k, v, g)
    _assert_close(got, want, "B=2 head_chunks=2")
    whole = band2.band2_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  tpf, window, span, m, logit_bound=SHIFT)
    np.testing.assert_allclose(whole.numpy(), got[0], atol=1e-6, rtol=1e-6)


def test_band2_rejects_an_illegal_plan():
    q = torch.zeros(1, 1, 960, 64)
    with pytest.raises(ValueError, match="no legal plan"):
        band2.band2_attention(q, q, q, 65, 8, 192, 2)   # 2 * 192 < C - 1
    with pytest.raises(ValueError, match="no legal plan"):
        band2.band2_attention(q, q, q, 65, 8, 200, 3)   # 200 does not tile L


# ------------------------------------------------------------ the plans

def test_plan_functions_match_jax(monkeypatch):
    """plan_candidates, best_plan and _next_cols equal the JAX package's
    with OWL_BAND2 unset, over tpf x window x L."""
    monkeypatch.delenv("OWL_BAND2", raising=False)
    for tpf in (8, 16, 64, 65):
        for window in (4, 8, 16):
            C = window * tpf
            for L in sorted({2 * C, 3 * C, 4 * C, 8 * C, 24 * C, 2080,
                             4096, 16384, 24960}):
                assert band2.plan_candidates(L, tpf, window) == \
                    jax_band2.plan_candidates(L, tpf, window), (L, tpf, window)
                assert band2.best_plan(L, tpf, window) == \
                    jax_band2.best_plan(L, tpf, window), (L, tpf, window)
    assert band2.best_plan(24960, 65, 16) == (520, 2)
    assert band2.best_plan(16384, 64, 16) == (256, 4)
    for S in range(8, 1100, 8):
        for tpf in (8, 16, 64, 65):
            assert band2._next_cols(S, tpf) == jax_band2._next_cols(S, tpf)


PLANS = [  # L, tpf, window, S, m
    (192, 16, 4, 32, 2), (256, 16, 8, 32, 4), (320, 16, 8, 64, 2),
    (192, 8, 4, 16, 2), (960, 65, 8, 192, 3), (576, 65, 4, 96, 3),
    (2080, 65, 16, 520, 2), (2080, 65, 16, 208, 5), (4096, 64, 16, 256, 4)]


@pytest.mark.parametrize("L,tpf,window,S,m", PLANS)
def test_kernel_walk_covers_every_visible_pair_once(L, tpf, window, S, m):
    """The kernels' walk, in Python: 128-row blocks over the closed-form
    window ranges (forward: 128-row key tiles; dq: 64-row key tiles; dkv:
    128-row key blocks over 64-row query tiles). Each kernel visits every
    visible pair exactly once and no pair twice, every tile a block visits
    holds a visible pair, FULL pairs hold only visible pairs; the plan's
    refs hold every visible pair, so a walk that ignores the plan gives the
    plan's output; and the exact tile classes refine the TPU's static ref
    classes (its ``_ref_class``)."""
    fc = band2._next_cols(S, tpf)
    vis = dense_mask(L, tpf, window, None, 0, True).numpy()
    for kind, height in walk.WALKS.items():
        for t0, o0 in walk.block_tiles(L, tpf, window, kind):
            r0, c0 = (o0, t0) if kind == "dkv" else (t0, o0)
            rows = height if kind == "dkv" else walk.BLOCK_ROWS
            cols = walk.BLOCK_ROWS if kind == "dkv" else height
            assert vis[r0:r0 + rows, c0:c0 + cols].any(), (kind, t0, o0)
        cover = np.zeros((L, L), np.int32)
        for (r0, r1), (c0, c1), cls in walk.band_walk(L, tpf, window, kind):
            blk = vis[r0:r1, c0:c1]
            if cls == walk.FULL:
                assert blk.shape == (r1 - r0, c1 - c0) and blk.all(), \
                    (kind, r0, c0)
            cover[r0:r1, c0:c1] += 1
        assert (cover[vis] == 1).all() and cover.max() == 1, kind
    # the plan: query chunk i reads kv chunks i - m .. i and the NEXT ref
    # of chunk i + 1 (gated at the edges)
    plan, nc = np.zeros((L, L), bool), L // S
    for i in range(nc):
        plan[i * S:(i + 1) * S, max(0, (i - m) * S):
             (i + 1) * S + (fc if i + 1 < nc else 0)] = True
    assert plan[vis].all()
    # exact classes never contradict the TPU's static ones (8-row blocks
    # of each chunk against each of its refs)
    for i in range(nc):
        for d in range(-1 if fc else 0, m + 1):
            if i - d < 0 or (d < 0 and i == nc - 1):
                continue    # refs gated at the edges
            c0 = (i - d) * S
            ncols = fc if d < 0 else S
            for r0 in range(0, S, 8):
                static = jax_band2._ref_class(r0, 8, S, tpf, window, d,
                                              ncols)
                exact = walk.tile_class(i * S + r0, i * S + r0 + 8, c0,
                                        c0 + ncols, L, tpf, window)
                if static != walk.PARTIAL:
                    assert exact == static, (i, d, r0)


@pytest.mark.parametrize("L,tpf,window,most_tiles,most_partial,full_share", [
    (24960, 65, 16, 11, 5, 0.65), (16384, 64, 16, 9, 2, 0.83),
    (4160, 65, 16, 10, 4, 0.63), (2080, 65, 16, 10, 4, 0.60)])
def test_kernel_walk_is_short(L, tpf, window, most_tiles, most_partial,
                              full_share):
    """The forward's walk at the window-16 geometries of the band paths:
    a 128-row block meets at most ``most_tiles`` key tiles of 128 rows
    (C / 128 + 1 or 2, the block's frames and the alignment), a consumer
    half inside L at most ``most_partial`` PARTIAL ones (the diagonal and
    the window's far edge, each one or two tiles wide where frames of 65
    rows straddle the tiles), and at least ``full_share`` of all (half,
    tile) pairs run unmasked."""
    per_block, partial, n_full, n = {}, {}, 0, 0
    for t0, _ in walk.block_tiles(L, tpf, window, "fwd"):
        per_block[t0] = per_block.get(t0, 0) + 1
    for (r0, r1), _, cls in walk.band_walk(L, tpf, window, "fwd"):
        if r1 <= L:
            partial[r0] = partial.get(r0, 0) + (cls == walk.PARTIAL)
        n_full, n = n_full + (cls == walk.FULL), n + 1
    assert max(per_block.values()) == most_tiles
    assert max(partial.values()) == most_partial
    assert n_full / n >= full_share


# -------------------------------------------------------------- routing

def _spy(calls, name, result):
    def fn(q, k, v, *a, **kw):
        plan = (a[2], a[3]) if name == "band2" else None
        calls.append((name, plan))
        return result(q)
    return fn


ROUTES = [  # tpf, window, L, local, overrides
    (65, 16, 2080, True, {}),                              # auto -> band2
    (65, 16, 24960, True, {}),                             # (520, 2)
    (65, 16, 2080, True, dict(local_attn_impl="band2")),
    (64, 16, 16384, True, {}),                             # frame-exact
    (64, 16, 16384, True, dict(local_attn_impl="band2")),  # (256, 4)
    (65, 16, 2080, True, dict(band_v2=False)),             # band
    (65, 16, 2080, True, dict(local_attn_impl="band2", band_v2=False)),
    (65, 16, 2080, True, dict(local_attn_impl="band")),
    (65, 8, 1040, True, {}),                               # no plan: band
    (65, 16, 2080, False, {}),                             # global: splash
    (65, 16, 2080, True, dict(local_attn_impl="splash")),
    (65, 16, 2080, True, dict(causal=False)),
    (65, 16, 3900, True, {}),                              # C does not divide
]


@pytest.mark.parametrize("tpf,window,L,local,over", ROUTES)
def test_train_attention_routes_band2_as_jax_does(tpf, window, L, local,
                                                  over, monkeypatch):
    """The port's train_attention takes band2, with the same plan, exactly
    where the JAX package's does. The JAX router is run with a TPU device
    mocked (its band kernels route on the TPU only) and both sides' kernels
    replaced by spies."""
    kw = dict(dict(tokens_per_frame=tpf, causal=True, local_window=window,
                   global_window=None), **over)
    jcalls, pcalls = [], []
    monkeypatch.setattr(jax_attn.jax, "devices", lambda *a: [
        types.SimpleNamespace(platform="tpu")])
    jzero = lambda q: jnp.zeros_like(q)
    monkeypatch.setattr(jax_band2, "band2_attention",
                        _spy(jcalls, "band2", jzero))
    monkeypatch.setattr(jax_band_mod, "band_attention",
                        _spy(jcalls, "band", jzero))
    monkeypatch.setattr(jax_splash, "splash_attention",
                        _spy(jcalls, "splash", jzero))
    monkeypatch.setattr(jax_local, "chunked_local_attention",
                        _spy(jcalls, "chunked", jzero))
    pzero = lambda q: torch.zeros_like(q)
    monkeypatch.setattr(band2, "band2_attention", _spy(pcalls, "band2", pzero))
    monkeypatch.setattr(band, "band_attention", _spy(pcalls, "band", pzero))
    monkeypatch.setattr(splash, "splash_attention",
                        _spy(pcalls, "splash", pzero))
    q = np.zeros((1, 1, L, 64), np.float32)
    jax_attn.train_attention(jax_config(**kw), local, *[jnp.asarray(q)] * 3)
    train_attention(transformer_config(**kw), local,
                    *[torch.from_numpy(q)] * 3)
    assert pcalls == jcalls and len(pcalls) == 1
    assert attention_route(transformer_config(**kw), local, L) == pcalls[0]


def test_pinned_band2_raises_where_jax_does(monkeypatch):
    monkeypatch.setattr(jax_attn.jax, "devices", lambda *a: [
        types.SimpleNamespace(platform="tpu")])
    q = np.zeros((1, 1, 256, 64), np.float32)
    for kw in (dict(tokens_per_frame=64, local_window=2),     # no plan
               dict(tokens_per_frame=65, local_window=16)):   # C does not
        kw.update(causal=True, local_attn_impl="band2")       # divide L
        with pytest.raises(ValueError, match="band2"):
            jax_attn.train_attention(jax_config(**kw), True,
                                     *[jnp.asarray(q)] * 3)
        with pytest.raises(ValueError, match="band2"):
            train_attention(transformer_config(**kw), True,
                            *[torch.from_numpy(q)] * 3)


def test_routed_band2_matches_the_frame_mask_route():
    """auto at tpf 65 and a pinned band2 at tpf 64 run band2 (the plain
    version on the CPU) and give the frame-mask kernel's output."""
    rs = np.random.RandomState(3)
    for tpf, L, impl in ((65, 2080, "auto"), (64, 4096, "band2")):
        q, k, v = (torch.from_numpy(a) for a in
                   _arrays(rs, 3, (1, 1, L, 64), normed=True))
        cfg = transformer_config(tokens_per_frame=tpf, causal=True,
                                 local_window=16, local_attn_impl=impl,
                                 band_fixed_shift=False)
        assert attention_route(cfg, True, L)[0] == "band2"
        got = train_attention(cfg, True, q, k, v)
        want = splash.splash_attention(q, k, v, tpf, 16, True)
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
