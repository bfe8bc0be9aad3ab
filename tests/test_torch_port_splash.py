"""The port's frame-mask flash attention (owl_audio_exps_tpu_torch/ops/
splash.py) against the JAX package's ``splash_attention``.

On the CPU the port's wrapper runs its plain version (dense mask +
dot_attention); the JAX side runs the splash Pallas kernel in interpret
mode, padding ragged lengths behind a sentinel segment as it does on the
TPU. Both in float32 on the same numpy inputs; tolerance atol 2e-5
(blockwise online softmax against one dense softmax).

The CUDA kernel itself runs only on a card: tests/test_torch_port_kernels.py
holds it against this plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_audio_exps_tpu.ops.splash import splash_attention as jax_splash
from owl_audio_exps_tpu_torch.ops import _attn_launch as kl
from owl_audio_exps_tpu_torch.ops import splash
from owl_audio_exps_tpu_torch.ops.masks import dense_mask

ATOL = 2e-5

CASES = {  # B, H, tpf, n_frames, window, causal, docs
    "causal_window": (1, 2, 5, 8, 3, True, False),
    "causal_no_window": (1, 2, 5, 8, None, True, False),
    "bidirectional_window": (1, 2, 5, 8, 3, False, False),
    "two_documents": (2, 2, 5, 8, None, True, True),
    "ragged_tpf65": (1, 2, 65, 2, 2, True, False),
    # ids that decrease, and one id in two separate runs (which see each
    # other: the ids are compared, not the runs)
    "decreasing_repeated_documents": (2, 2, 5, 8, None, True, "odd"),
    "decreasing_repeated_bidirectional": (2, 2, 5, 8, 3, False, "odd"),
}


def _doc_ids(docs, nf):
    """Per-frame ids of a case: row 0 documents of 3 + 5 frames, row 1 of
    6 + 2; or ("odd") ids that decrease and come back."""
    if docs == "odd":
        return np.array([[2, 2, 0, 0, 2, 2, 1, 1],
                         [1, 0, 0, 1, 1, 0, 2, 2]], np.int32)[:, :nf]
    return np.stack([np.arange(nf) >= 3, np.arange(nf) >= 6]).astype(
        np.int32)


def _inputs(B, H, L, Dh=64, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, H, L, Dh).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_splash_interpret(case):
    B, H, tpf, nf, window, causal, docs = CASES[case]
    L = tpf * nf
    q, k, v = _inputs(B, H, L)
    doc = _doc_ids(docs, nf) if docs else None
    before = splash.launches
    ref = jax_splash(*(jnp.asarray(a) for a in (q, k, v)), tpf, window,
                     causal, None if doc is None else jnp.asarray(doc),
                     interpret=True)
    got = splash.splash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), tpf, window, causal,
        None if doc is None else torch.from_numpy(doc))
    assert got.shape == (B, H, L, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)
    assert splash.launches == before   # CPU tensors never reach the kernel


@pytest.mark.parametrize("case", ["two_documents",
                                  "decreasing_repeated_documents"])
def test_plain_gradients_match_jax_splash_interpret(case):
    """dq, dk, dv of the port's K1 (its plain version on the CPU) against
    the JAX splash's custom vjp in interpret mode, with documents."""
    import jax

    B, H, tpf, nf, window, causal, docs = CASES[case]
    L = tpf * nf
    q, k, v = _inputs(B, H, L)
    g = _inputs(B, H, L, seed=1)[0]
    doc = _doc_ids(docs, nf)
    _, vjp = jax.vjp(lambda *a: jax_splash(*a, tpf, window, causal,
                                            jnp.asarray(doc),
                                            interpret=True),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    splash.splash_attention(*leaves, tpf, window, causal,
                            torch.from_numpy(doc)).backward(
                                torch.from_numpy(g))
    for name, a, b in zip(("dq", "dk", "dv"), leaves, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0, err_msg=name)


def test_head_chunks_and_scale():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 40))
    full = splash.splash_attention(q, k, v, 5, 2, True)
    chunked = splash.splash_attention(q, k, v, 5, 2, True, head_chunks=2)
    torch.testing.assert_close(chunked, full, atol=0, rtol=0)
    # the default scale is Dh^-0.5 applied to q
    scaled = splash.splash_attention(q * 64 ** -0.5, k, v, 5, 2, True,
                                     scale=1.0)
    torch.testing.assert_close(scaled, full, atol=1e-6, rtol=0)


@pytest.mark.parametrize("L,tpf,window,causal,docs", [
    (40, 5, 3, True, None), (40, 5, None, True, None),
    (40, 5, 3, False, None), (130, 65, None, False, None),
    (42, 5, 2, True, [0, 0, 1, 1, 1, 2, 2, 2, 2])])
def test_visible_pairs_counts_the_mask(L, tpf, window, causal, docs):
    doc = None if docs is None else torch.tensor([docs])
    mask = dense_mask(L, tpf, window, doc, 0, causal)
    assert splash.visible_pairs(L, tpf, window, causal, docs) == \
        int(mask.sum())


def test_kernel_wrapper_rejects_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 40))
    before = splash.launches
    with pytest.raises(ValueError, match="CUDA"):
        splash.frame_attention_cuda(q, k, v, 5, 2, True)
    assert splash.launches == before


# ---- the tensor maps of the Hopper kernels (csrc/hopper_attention.cuh
# encode_map computes the same geometry from the strides it is given)

def _fused_views(B, L, H, Dh):
    """q, k, v as Attn hands them over: [B, H, L, Dh] views of the fused
    [B, L, 3, H, Dh] projection."""
    qkv = torch.zeros(B, L, 3, H, Dh, dtype=torch.bfloat16)
    return [qkv[:, :, i].transpose(1, 2) for i in range(3)]


@pytest.mark.parametrize("B,L,H,Dh", [(1, 3900, 24, 64), (2, 455, 4, 64),
                                      (1, 1040, 2, 128)])
def test_tma_geometry_of_attn_views(B, L, H, Dh):
    for t in _fused_views(B, L, H, Dh):
        geo = kl.tma_geometry(t.shape, t.stride(), t.data_ptr(), 128)
        row = 3 * H * Dh * 2      # 9,216 bytes at 24 heads of 64
        assert geo["dims"] == (Dh, L, H, B)
        assert geo["strides"] == (row, Dh * 2, L * row if B > 1 else
                                  Dh * 2 * H)
        assert geo["box"] == (64, 128, 1, 1)
        assert kl.tma_operand("q", t) is t   # read in place, never copied


@pytest.mark.parametrize("B,H,L,n", [(1, 24, 98_304, 4), (2, 3, 1000, 2)])
def test_tma_geometry_of_ring_slices(B, H, L, n):
    """The ring and the halo hand over contiguous [B, H, L, Dh] tensors or
    slices of them along L; the kernel's output is a [B, H, L, Dh] view of
    [B, L, H, Dh] storage (empty_heads)."""
    full = torch.zeros(B, H, L, 64, dtype=torch.bfloat16)
    per = L // n
    for i in range(n):
        t = full[:, :, i * per:(i + 1) * per]
        geo = kl.tma_geometry(t.shape, t.stride(), t.data_ptr(), 64)
        assert geo["dims"] == (64, per, H, B)
        assert geo["strides"] == (128, L * 128, H * L * 128)
        assert geo["box"] == (64, 64, 1, 1)
    out = kl.empty_heads(full)
    geo = kl.tma_geometry(out.shape, out.stride(), out.data_ptr(), 128)
    assert geo["strides"][:2] == (H * 64 * 2, 128)


@pytest.mark.parametrize("shape,stride,want", [
    # one head sliced out of the fused projection: its head stride of
    # Dh is replaced by the dense L * row
    ((1, 1, 455, 64), (455 * 3 * 64, 64, 3 * 64, 1), (455 * 192, 455 * 192,
                                                       192)),
    # an expanded batch and head (stride 0) and a single row
    ((1, 1, 1, 128), (0, 0, 0, 1), (128, 128, 128)),
    # nothing of extent 1: the strides as they are
    ((2, 3, 10, 64), (5000, 64, 192, 1), (5000, 64, 192)),
])
def test_map_strides_give_extent_one_dims_their_dense_stride(shape, stride,
                                                             want):
    """The strides every entry point receives (``launch``) and the K1/K4
    tensor maps are built from: only a dim of extent 1 is changed."""
    assert kl.map_strides(shape, stride) == want
    if shape[-1] in (64, 128):
        geo = kl.tma_geometry(shape, stride, 0, 64)
        assert geo["strides"] == tuple(2 * s for s in reversed(want))


def test_tma_geometry_rejects_views_tma_cannot_take():
    q = torch.zeros(1, 2, 256, 64, dtype=torch.bfloat16)
    wide = torch.zeros(1, 2, 256, 68, dtype=torch.bfloat16)
    cases = {
        "contiguous": torch.zeros(1, 2, 64, 256,             # Dh strided
                                  dtype=torch.bfloat16).transpose(2, 3),
        "multiples of 16": wide[..., :64],                   # 136-byte rows
        "aligned": wide.view(-1)[1:1 + 2 * 256 * 64].view(1, 2, 256, 64),
        "head dim": torch.zeros(1, 2, 256, 32, dtype=torch.bfloat16),
        "positive": q[:, :1].expand(1, 2, 256, 64),          # zero head stride
    }
    for match, t in cases.items():
        with pytest.raises(ValueError, match=match):
            kl.tma_geometry(t.shape, t.stride(), t.data_ptr(), 64)
        with pytest.raises(ValueError, match="^dout: "):
            kl.tma_operand("dout", t)


def test_dense_cotangent_copies_only_what_tma_cannot_take():
    out = kl.empty_heads(torch.zeros(1, 2, 130, 64, dtype=torch.bfloat16))
    assert kl.dense_cotangent(out) is out          # a strided view, in place
    ones = torch.ones(()).expand(1, 2, 130, 64)    # the gradient of .sum()
    g = kl.dense_cotangent(ones)
    assert g.dtype == torch.bfloat16 and g.is_contiguous()
    assert torch.equal(g.float(), ones)
