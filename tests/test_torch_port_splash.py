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
from owl_audio_exps_tpu_torch.ops import splash
from owl_audio_exps_tpu_torch.ops.masks import dense_mask

ATOL = 2e-5

CASES = {  # B, H, tpf, n_frames, window, causal, docs
    "causal_window": (1, 2, 5, 8, 3, True, False),
    "causal_no_window": (1, 2, 5, 8, None, True, False),
    "bidirectional_window": (1, 2, 5, 8, 3, False, False),
    "two_documents": (2, 2, 5, 8, None, True, True),
    "ragged_tpf65": (1, 2, 65, 2, 2, True, False),
}


def _inputs(B, H, L, Dh=64, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, H, L, Dh).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_splash_interpret(case):
    B, H, tpf, nf, window, causal, docs = CASES[case]
    L = tpf * nf
    q, k, v = _inputs(B, H, L)
    doc = None
    if docs:  # row 0: documents of 3 + 5 frames; row 1: 6 + 2
        doc = np.stack([np.arange(nf) >= 3, np.arange(nf) >= 6]).astype(
            np.int32)
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
