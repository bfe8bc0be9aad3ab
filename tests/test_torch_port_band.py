"""The port's band attention (owl_audio_exps_tpu_torch/ops/band.py) and the
gradients of its frame-mask attention (ops/splash.py) against the JAX
package, on the CPU.

On the CPU the port's wrappers run their plain versions, and autograd
over them is the plain backward; the JAX side runs its Pallas kernels in
interpret mode (band_attention's custom vjp, splash's library backward)
and ``jax.grad``. Both in float32 on the same numpy inputs. Tolerances
(stated per test): forward atol 3e-5, gradients atol/rtol 2e-4, as the
JAX package's own band tests hold its kernel to the dense oracle.

The CUDA kernels run only on a card: tests/test_torch_port_kernels.py
holds them against these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_audio_exps_tpu.ops.attention import dot_attention as jax_dot
from owl_audio_exps_tpu.ops.band import band_attention as jax_band
from owl_audio_exps_tpu.ops.band import band_available as jax_available
from owl_audio_exps_tpu.ops.masks import dense_mask as jax_dense_mask
from owl_audio_exps_tpu.ops.splash import splash_attention as jax_splash
from owl_audio_exps_tpu_torch.configs import transformer_config
from owl_audio_exps_tpu_torch.nn.attn import train_attention
from owl_audio_exps_tpu_torch.ops import band, band2, splash

FWD_ATOL = 3e-5
GRAD_TOL = 2e-4


def _arrays(rs, n, shape, normed=False):
    out = [rs.randn(*shape).astype(np.float32) for _ in range(n)]
    if normed:  # unit-RMS q and k, as the attention module's rms_norm
        for i in (0, 1):
            out[i] = out[i] / np.sqrt(np.mean(out[i] ** 2, -1, keepdims=True)
                                      + 1e-6)
    return out


def _jax_grads(fn, q, k, v, g):
    loss = lambda q, k, v: jnp.vdot(fn(q, k, v), g)
    return jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))


def _port_grads(fn, q, k, v, g):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fn(*ts)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach(), [t.grad for t in ts]


def _close(got, want, tol, what):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol,
                                   rtol=tol, err_msg=f"{what} {name}")


# the cases of tests/test_band_attention.py:24-30 and :44-52 (batched)
BAND_CASES = {
    "C128_minimal": (1, 64, 2, 2),
    "C128_5chunks": (1, 64, 2, 5),
    "C256": (1, 32, 8, 3),
    "window1": (1, 128, 1, 4),
    "tpf65_C520": (1, 65, 8, 2),
    "batched": (3, 64, 2, 4),
}


@pytest.mark.parametrize("bound", [None, 40.0], ids=["rowmax", "shift40"])
@pytest.mark.parametrize("case", list(BAND_CASES))
def test_band_plain_matches_jax_band(case, bound):
    B, tpf, window, n_chunks = BAND_CASES[case]
    L = window * tpf * n_chunks
    rs = np.random.RandomState(0)
    q, k, v, g = _arrays(rs, 4, (B, 2, L, 64))
    assert band.band_available(L, tpf, window, True)
    jfn = lambda q, k, v: jax_band(q, k, v, tpf, window, interpret=True,
                                   logit_bound=bound)
    want = jfn(*(jnp.asarray(a) for a in (q, k, v)))
    fwd = band.fwd_launches
    got, grads = _port_grads(lambda *a: band.band_attention(
        *a, tpf, window, logit_bound=bound), q, k, v, g)
    assert band.fwd_launches == fwd   # CPU tensors never reach the kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=FWD_ATOL, rtol=FWD_ATOL)
    if case in ("C128_minimal", "window1", "tpf65_C520"):
        _close(grads, _jax_grads(jfn, q, k, v, g), GRAD_TOL, case)


@pytest.mark.parametrize("tpf,window,n_chunks", [(64, 2, 3), (65, 8, 2)])
def test_band_fixed_shift_matches_jax(tpf, window, n_chunks):
    """The fixed-shift cases of tests/test_band_attention.py:101-143:
    unit-RMS q/k and bound sqrt(Dh), forward and gradients."""
    L = window * tpf * n_chunks
    rs = np.random.RandomState(7)
    q, k, v, g = _arrays(rs, 4, (1, 2, L, 64), normed=True)
    jfn = lambda q, k, v: jax_band(q, k, v, tpf, window, interpret=True,
                                   logit_bound=8.0)
    got, grads = _port_grads(lambda *a: band.band_attention(
        *a, tpf, window, logit_bound=8.0), q, k, v, g)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jfn(*(jnp.asarray(a) for a in (q, k, v)))),
        atol=FWD_ATOL, rtol=FWD_ATOL)
    _close(grads, _jax_grads(jfn, q, k, v, g), GRAD_TOL, "fixed shift")


def test_band_clamp_is_part_of_the_function():
    """Logits above the bound are clamped in the forward and pass their
    gradient straight through, as the TPU kernel's custom vjp does: with a
    bound below the largest logits the plain version still matches JAX
    for any input."""
    tpf, window, L = 64, 2, 384
    rs = np.random.RandomState(9)
    q, k, v, g = _arrays(rs, 4, (1, 2, L, 64))
    q = q * 3.0   # logits up to ~25, bound 4
    jfn = lambda q, k, v: jax_band(q, k, v, tpf, window, interpret=True,
                                   logit_bound=4.0)
    got, grads = _port_grads(lambda *a: band.band_attention_plain(
        *a, tpf, window, 4.0), q, k, v, g)
    want = np.asarray(jfn(*(jnp.asarray(a) for a in (q, k, v))))
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_ATOL,
                               rtol=FWD_ATOL)
    # the clamp changes the function: it differs from the plain softmax
    assert np.abs(want - band.band_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), tpf, window).numpy()
    ).max() > 1e-3
    _close(grads, _jax_grads(jfn, q, k, v, g), GRAD_TOL, "clamped")


@pytest.mark.parametrize("L,tpf,window,causal", [
    (512, 64, None, True), (512, 64, 2, False), (600, 64, 2, True),
    (128, 64, 2, True), (260, 65, 1, True), (512, 64, 2, True),
    (98304, 64, 16, True), (1040, 65, 8, True), (16384, 64, 16, True),
    (3900, 65, 16, True), (4160, 65, 16, True)])
def test_band_available_matches_jax(L, tpf, window, causal):
    assert band.band_available(L, tpf, window, causal) == \
        jax_available(L, tpf, window, causal)


SPLASH_CASES = {  # B, L, tpf, window, causal, per-frame documents
    "causal_window": (1, 40, 5, 3, True, None),
    "bidirectional_ragged": (1, 130, 65, None, False, None),
    "bidirectional_window": (1, 40, 5, 2, False, None),
    "causal_window_documents_ragged": (
        1, 43, 5, 2, True, [[0, 0, 0, 1, 1, 1, 1, 2, 2]]),
}


@pytest.mark.parametrize("case", list(SPLASH_CASES))
def test_splash_plain_gradients_match_jax(case):
    """Against jax.grad of splash in interpret mode; with documents on a
    ragged length against jax.grad of dot_attention over dense_mask (the
    library's padded backward rejects segment ids there)."""
    B, L, tpf, window, causal, docs = SPLASH_CASES[case]
    rs = np.random.RandomState(1)
    q, k, v, g = _arrays(rs, 4, (B, 2, L, 64))
    doc = None if docs is None else np.asarray(docs, np.int32)
    if doc is None:
        jfn = lambda q, k, v: jax_splash(q, k, v, tpf, window, causal,
                                         interpret=True)
    else:
        mask = jax_dense_mask(L, tpf, window, jnp.asarray(doc), 0, causal)
        jfn = lambda q, k, v: jax_dot(q, k, v, mask)
    before = (splash.launches, splash.dq_launches, splash.dkv_launches)
    got, grads = _port_grads(lambda *a: splash.splash_attention(
        *a, tpf, window, causal,
        None if doc is None else torch.from_numpy(doc)), q, k, v, g)
    assert (splash.launches, splash.dq_launches,
            splash.dkv_launches) == before
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jfn(*(jnp.asarray(a) for a in (q, k, v)))),
        atol=FWD_ATOL, rtol=0)
    _close(grads, _jax_grads(jfn, q, k, v, g), GRAD_TOL, case)


def _route_cfg(**kw):
    return transformer_config(**dict(dict(
        tokens_per_frame=64, causal=True, local_window=2,
        global_window=None), **kw))


def test_train_attention_routes_local_windows_to_the_band():
    rs = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(a) for a in
               _arrays(rs, 3, (1, 2, 256, 64), normed=True))
    calls = []
    orig_band, orig_splash = band.band_attention, splash.splash_attention
    orig_band2 = band2.band2_attention

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append((name, kw.get("logit_bound")))
            return fn(*a, **kw)
        return wrapped

    band.band_attention = spy("band", orig_band)
    splash.splash_attention = spy("splash", orig_splash)
    band2.band2_attention = spy("band2", orig_band2)
    try:
        for impl in ("auto", "band"):
            train_attention(_route_cfg(local_attn_impl=impl), True, q, k, v)
        train_attention(_route_cfg(band_fixed_shift=False), True, q, k, v)
        train_attention(_route_cfg(), False, q, k, v)            # global
        train_attention(_route_cfg(local_attn_impl="splash"), True, q, k, v)
        train_attention(_route_cfg(), True, q, k, v,              # documents
                        doc_id=torch.zeros(1, 4, dtype=torch.int32))
        train_attention(_route_cfg(causal=False), True, q, k, v)  # bidir
        train_attention(_route_cfg(local_window=3), True, q, k, v)  # C ∤ L
        with pytest.raises(ValueError, match="local_attn_impl=band"):
            train_attention(_route_cfg(local_window=3, local_attn_impl="band"),
                            True, q, k, v)
        # a pinned band2 takes best_plan's plan at any tpf (tpf 64, a
        # window of 8: (256, 2) at L 1,024) and gives the frame-mask
        # route's output; it raises where there is no plan
        q8, k8, v8 = (torch.from_numpy(a) for a in
                      _arrays(rs, 3, (1, 2, 1024, 64), normed=True))
        got = train_attention(_route_cfg(local_window=8,
                                         local_attn_impl="band2"), True,
                              q8, k8, v8)
        want = splash.splash_attention_plain(q8, k8, v8, 64, 8, True)
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
        with pytest.raises(ValueError, match="no legal band2 plan"):
            train_attention(_route_cfg(local_attn_impl="band2"), True,
                            q, k, v)
        # a pinned chunked runs ops/local.py (plain PyTorch): the same
        # function as the band's usual softmax; it raises where its chunk
        # does not divide the sequence
        got = train_attention(_route_cfg(local_attn_impl="chunked"), True,
                              q, k, v)
        want = band.band_attention_plain(q, k, v, 64, 2)
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
        with pytest.raises(ValueError, match="local_attn_impl=chunked"):
            train_attention(_route_cfg(local_window=3,
                                       local_attn_impl="chunked"), True,
                            q, k, v)
    finally:
        band.band_attention, splash.splash_attention = orig_band, orig_splash
        band2.band2_attention = orig_band2
    assert calls == [("band", 8.0), ("band", 8.0), ("band", None)] + \
        [("splash", None)] * 5 + [("band2", 8.0)]
