"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests carry the ``cuda`` marker and skip without a GPU (a CUDA
kernel has no CPU mode). They import neither JAX nor the JAX package, so
they also run on a GPU machine without JAX; tests/conftest.py imports
JAX, so there run them without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_kernels.py

chip_smoke.py holds the same kernel at the full serve geometries.
"""

import pytest
import torch

from owl_audio_exps_tpu_torch.ops import splash


@pytest.mark.cuda
@pytest.mark.parametrize("L,tpf,window,causal,docs", [
    (130, 65, 2, True, False), (1040, 65, 16, False, False),
    (1024, 64, None, True, False), (650, 65, None, True, True)])
def test_kernel_matches_plain_on_card(L, tpf, window, causal, docs):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(1, 4, L, 64, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    nf = -(-L // tpf)
    doc = ((torch.arange(nf, device="cuda") >= nf // 2).int()[None]
           if docs else None)
    before = splash.launches
    out = splash.splash_attention(q, k, v, tpf, window, causal, doc)
    torch.cuda.synchronize()
    assert splash.launches == before + 1
    ref = splash.splash_attention_plain(q.float(), k.float(), v.float(),
                                        tpf, window, causal, doc)
    err = (out.float() - ref).abs()
    # bf16 P and bf16 output against float32 softmax and PV (the
    # tolerance chip_smoke.py states)
    assert err.max().item() < 2e-2 and err.mean().item() < 2e-3


@pytest.mark.cuda
def test_kernel_reads_strided_views_and_rejects_what_it_cannot_run():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(1)
    B, L, H, Dh = 2, 260, 4, 64
    # the layout Attn hands over: [B, H, L, Dh] views of [B, L, 3, H, Dh]
    qkv = torch.randn(B, L, 3, H, Dh, generator=gen,
                      device="cuda").to(torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    out = splash.splash_attention(q, k, v, 65, 2, True)
    ref = splash.splash_attention(*(t.contiguous() for t in (q, k, v)),
                                  65, 2, True)
    torch.cuda.synchronize()
    assert out.shape == (B, H, L, Dh)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    with pytest.raises(NotImplementedError, match="bf16"):
        splash.splash_attention(q.float(), k.float(), v.float(), 65, 2, True)
    with pytest.raises(NotImplementedError, match="backward"):
        splash.splash_attention(q.detach().requires_grad_(), k, v, 65, 2,
                                True)
