"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests carry the ``cuda`` marker and skip without a GPU (a CUDA
kernel has no CPU mode). They import neither JAX nor the JAX package, so
they also run on a GPU machine without JAX; tests/conftest.py imports
JAX, so there run them without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_kernels.py

chip_smoke.py holds the same kernels at the full serve and training
geometries.
"""

import pytest
import torch

from owl_audio_exps_tpu_torch.ops import band, band2, splash

# gradients: kernel (bf16 in and out, bf16 P and dS) against autograd of
# the plain version in float32 on the same bf16 inputs, as relative L2
# error per tensor (the tolerance chip_smoke.py states)
GRAD_REL_L2 = 2e-2


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _qkv(L, H=4, seed=0, normed=False, Dh=64, B=1):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ts = [torch.randn(B, H, L, Dh, generator=gen, device="cuda")
          for _ in range(3)]
    if normed:  # unit-RMS q and k, as QK rms-norm produces
        for i in (0, 1):
            ts[i] = ts[i] * torch.rsqrt(ts[i].pow(2).mean(-1, keepdim=True))
    return [t.to(torch.bfloat16) for t in ts]


def _grads(fn, q, k, v, dout):
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = fn(q, k, v)
    out.backward(dout)
    return out, (q.grad, k.grad, v.grad)


def _rel_l2(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("L,tpf,window,causal,docs", [
    (130, 65, 2, True, False), (1040, 65, 16, False, False),
    (1024, 64, None, True, False), (650, 65, None, True, True)])
def test_kernel_matches_plain_on_card(L, tpf, window, causal, docs):
    _need_card()
    q, k, v = _qkv(L)
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
@pytest.mark.parametrize("L,tpf,window,causal,docs", [
    (130, 65, 2, True, False), (1040, 65, 16, False, False),
    (1024, 64, None, True, False), (650, 65, None, True, True),
    (1000, 64, 3, True, True), (455, 65, 2, False, True)])
def test_kernel_backward_matches_plain_on_card(L, tpf, window, causal, docs):
    _need_card()
    q, k, v = _qkv(L, seed=1)
    dout = _qkv(L, seed=2)[0]
    nf = -(-L // tpf)
    doc = ((torch.arange(nf, device="cuda") >= nf // 3).int()[None]
           if docs else None)
    counts = (splash.launches, splash.dq_launches, splash.dkv_launches)
    out, got = _grads(lambda *a: splash.splash_attention(
        *a, tpf, window, causal, doc), q, k, v, dout)
    torch.cuda.synchronize()
    assert (splash.launches, splash.dq_launches, splash.dkv_launches) == \
        tuple(c + 1 for c in counts)
    _, want = _grads(lambda *a: splash.splash_attention_plain(
        *a, tpf, window, causal, doc), q.float(), k.float(), v.float(),
        dout.float())
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a).all(), name
        assert _rel_l2(a, b) < GRAD_REL_L2, name


# per-frame ids of K1's document walk: ids that never decrease (short
# documents, boundaries in mid-tile at tpf 65), and ids that decrease and
# come back (no clip; the ids compared per element)
DOC_LAYOUTS = {
    "short": lambda nf: torch.arange(nf) // 7,
    "decreasing_repeated": lambda nf: 2 - (torch.arange(nf) // 5) % 3,
}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(DOC_LAYOUTS))
@pytest.mark.parametrize("L,tpf,window,causal,Dh", [
    (4160, 65, None, True, 64), (4096, 64, 16, True, 128),
    (1300, 13, 3, False, 64)])
def test_document_walk_matches_plain_on_card(layout, L, tpf, window, causal,
                                             Dh):
    """K1's kDoc bodies, forward and backward, against the plain version,
    and the summary kernel's output against the plain doc_tiles int for
    int."""
    _need_card()
    from owl_audio_exps_tpu_torch.ops import doc_tiles
    nf = -(-L // tpf)
    doc = torch.stack([DOC_LAYOUTS[layout](nf), torch.arange(nf) // 9]
                      ).int().cuda()
    q, k, v = _qkv(L, seed=5, Dh=Dh, B=2)
    dout = _qkv(L, seed=6, Dh=Dh, B=2)[0]
    before = doc_tiles.launches
    docs = splash.doc_tiles_for(doc, q, tpf, window, causal)
    assert doc_tiles.launches == before + 1
    assert torch.equal(docs.summary.cpu(), doc_tiles.doc_tiles(
        doc.cpu(), L, tpf, window, causal))
    out, got = _grads(lambda *a: splash.splash_attention(
        *a, tpf, window, causal, doc), q, k, v, dout)
    torch.cuda.synchronize()
    want_out, want = _grads(lambda *a: splash.splash_attention_plain(
        *a, tpf, window, causal, doc), q.float(), k.float(), v.float(),
        dout.float())
    err = (out.float() - want_out).abs()
    assert err.max().item() < 2e-2 and err.mean().item() < 2e-3
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a).all(), name
        assert _rel_l2(a, b) < GRAD_REL_L2, name


@pytest.mark.cuda
@pytest.mark.parametrize("window", [16, None])
def test_kernel_with_packed_documents_matches_plain_on_card(window,
                                                             tmp_path):
    """K1 forward and backward with the per-frame doc_id the
    sequence-packing loader yields for a 64-frame window (tpf 64, L
    4,096) of a table of five documents, against the plain version."""
    _need_card()
    import numpy as np
    from owl_audio_exps_tpu_torch.data.latent_seq_packing import \
        PackedSequenceDataset
    from owl_audio_exps_tpu_torch.data.npy_table import NpyTable
    table = NpyTable(str(tmp_path / "tbl"), columns=[
        "video", "tarball", "pt_idx", "missing", "truncated", "seq_len"],
        array_columns=["video"])
    for i, n in enumerate((30, 21, 45, 9, 40)):
        table.append(video=np.zeros((n, 1), np.float16), tarball="t",
                     pt_idx=i, missing=False, truncated=False, seq_len=n)
    ds = PackedSequenceDataset(str(tmp_path / "tbl"), 64)
    ds.set_epoch(1)
    doc = torch.from_numpy(ds[1]["doc_id"])[None].cuda()
    assert doc.dtype == torch.int32 and len(set(doc[0].tolist())) > 2
    q, k, v = _qkv(4096, seed=3)
    dout = _qkv(4096, seed=4)[0]
    out, got = _grads(lambda *a: splash.splash_attention(
        *a, 64, window, True, doc), q, k, v, dout)
    torch.cuda.synchronize()
    want_out, want = _grads(lambda *a: splash.splash_attention_plain(
        *a, 64, window, True, doc), q.float(), k.float(), v.float(),
        dout.float())
    assert (out.float() - want_out).abs().max().item() < 2e-2
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a).all(), name
        assert _rel_l2(a, b) < GRAD_REL_L2, name


@pytest.mark.cuda
def test_kernels_refuse_a_jvp_on_card():
    """Under torch.func.jvp (MeanFlow's objective at L >= 1024) K1 and the
    band kernels raise instead of launching without the tangents."""
    _need_card()
    q, k, v = _qkv(1024, seed=5)
    ones = torch.ones_like(q)
    for fn in (lambda a: splash.splash_attention(a, k, v, 64, None, True),
               lambda a: band.band_attention(a, k, v, 64, 4)):
        with pytest.raises(RuntimeError, match="torch.func transform"):
            torch.func.jvp(fn, (q,), (ones,))


@pytest.mark.cuda
@pytest.mark.parametrize("B,window", [(2, 16), (2, None), (8, 16)])
def test_kernel_at_the_distill_geometry_matches_plain_on_card(B, window):
    """K1 forward, dq and dkv at the distillation window (60 frames x 64
    tokens, L 3,840, which the band span 1,024 does not divide, so local
    layers take K1 too) at B > 1: 2 samples, and the ODE student's 8
    trajectory states stacked on the batch axis."""
    _need_card()
    L, tpf = 3840, 64
    q, k, v = _qkv(L, seed=3, normed=True, B=B)
    dout = _qkv(L, seed=4, B=B)[0]
    counts = (splash.launches, splash.dq_launches, splash.dkv_launches)
    out, got = _grads(lambda *a: splash.splash_attention(
        *a, tpf, window, True), q, k, v, dout)
    torch.cuda.synchronize()
    assert (splash.launches, splash.dq_launches, splash.dkv_launches) == \
        tuple(c + 1 for c in counts)
    ref, want = _grads(lambda *a: splash.splash_attention_plain(
        *a, tpf, window, True), q.float(), k.float(), v.float(),
        dout.float())
    err = (out.float() - ref).abs()
    assert err.max().item() < 2e-2 and err.mean().item() < 2e-3
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a).all(), name
        assert _rel_l2(a, b) < GRAD_REL_L2, name
    # each sample of the batch is the kernel's own B 1 result
    one = splash.splash_attention(q[1:2], k[1:2], v[1:2], tpf, window,
                                  True)
    assert torch.equal(one, out[1:2].detach())


@pytest.mark.cuda
@pytest.mark.parametrize("window", [16, 256])
def test_kernel_at_the_mmdit_geometry_matches_plain_on_card(window):
    """K1 forward, dq and dkv at the MMDiT's token layout (tpf 65: 64
    video tokens and 1 audio token a frame) with configs/mmdit_v2.yml's
    frame windows, causal, at 300 frames: L 19,500, which the 128-row
    tile does not divide (the ragged tail of L 65,000 too) and which the
    256-frame window cuts."""
    _need_card()
    L, tpf = 300 * 65, 65
    q, k, v = _qkv(L, H=2, seed=6, normed=True)
    dout = _qkv(L, H=2, seed=7)[0]
    counts = (splash.launches, splash.dq_launches, splash.dkv_launches)
    out, got = _grads(lambda *a: splash.splash_attention(
        *a, tpf, window, True), q, k, v, dout)
    torch.cuda.synchronize()
    assert (splash.launches, splash.dq_launches, splash.dkv_launches) == \
        tuple(c + 1 for c in counts)
    ref, want = _grads(lambda *a: splash.splash_attention_plain(
        *a, tpf, window, True), q.float(), k.float(), v.float(),
        dout.float())
    err = (out.float() - ref).abs()
    assert err.max().item() < 2e-2 and err.mean().item() < 2e-3
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a).all(), name
        assert _rel_l2(a, b) < GRAD_REL_L2, name


@pytest.mark.cuda
def test_mmdit_core_through_k1_matches_dense_on_card():
    """A 2-layer MMDiT core at 16 frames x tpf 65 (L 1,040, the K1 route)
    launches K1 once a layer and agrees with its dense route (relative
    L2 5e-2, chip_smoke.py's forward limit)."""
    _need_card()
    from owl_audio_exps_tpu_torch.configs import transformer_config
    from owl_audio_exps_tpu_torch.models.gamerft_audio import \
        GameRFTAudioCore
    kw = dict(model_id="game_rft_audio", n_layers=2, n_heads=4,
              d_model=256, channels=16, audio_channels=8, sample_size=8,
              tokens_per_frame=65, n_frames=16, n_buttons=3, causal=True,
              uncond=False, has_audio=True, rope_impl="ortho",
              local_window=4, global_window=None, cfg_prob=0.0,
              backbone="mmdit")
    cfg = transformer_config(**kw)
    core = GameRFTAudioCore(cfg, device="cuda", seed=0).to(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(8)
    bf = torch.bfloat16
    args = (torch.randn(1, 16, 16, 8, 8, generator=gen, device="cuda"),
            torch.randn(1, 16, 8, generator=gen, device="cuda"),
            torch.rand(1, 16, generator=gen, device="cuda"),
            torch.randn(1, 16, 2, generator=gen, device="cuda"),
            torch.zeros(1, 16, 3, device="cuda"))
    args = tuple(a.to(bf) for a in args)
    before = splash.launches
    with torch.no_grad():
        kv, ka = core(*args)
        assert splash.launches == before + 2
        cfg.attn_impl = "dense"
        dv, da = core(*args)
    assert splash.launches == before + 2
    assert _rel_l2(kv, dv) < 5e-2 and _rel_l2(ka, da) < 5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("tpf,window,n_chunks,bound", [
    (64, 2, 3, None), (64, 2, 3, 8.0), (65, 8, 2, 8.0), (65, 16, 2, None),
    (128, 1, 4, 8.0)])
def test_band_kernel_matches_plain_on_card(tpf, window, n_chunks, bound):
    _need_card()
    L = window * tpf * n_chunks
    q, k, v = _qkv(L, seed=3, normed=True)
    dout = _qkv(L, seed=4)[0]
    counts = (band.fwd_launches, band.bwd_launches)
    out, got = _grads(lambda *a: band.band_attention(
        *a, tpf, window, logit_bound=bound), q, k, v, dout)
    torch.cuda.synchronize()
    assert (band.fwd_launches, band.bwd_launches) == \
        (counts[0] + 1, counts[1] + 1)
    ref, want = _grads(lambda *a: band.band_attention_plain(
        *a, tpf, window, bound), q.float(), k.float(), v.float(),
        dout.float())
    err = (out.float() - ref).abs()
    assert err.max().item() < 2e-2 and err.mean().item() < 2e-3
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a).all(), name
        assert _rel_l2(a, b) < GRAD_REL_L2, name


@pytest.mark.cuda
@pytest.mark.parametrize("L,tpf,window,span,nrefs,bound", [
    (1024, 64, 4, 128, 2, 8.0),      # aligned
    (2080, 65, 16, 520, 2, None),    # aligned, the AV model's plan
    (960, 65, 8, 192, 3, 8.0),       # ragged: a NEXT ref of 96 columns
    (2080, 65, 16, 208, 5, None)])   # ragged: a NEXT ref of 104 columns
def test_band2_kernel_matches_plain_on_card(L, tpf, window, span, nrefs,
                                            bound):
    _need_card()
    q, k, v = _qkv(L, seed=5, normed=True)
    dout = _qkv(L, seed=6)[0]
    counts = (band2.fwd_launches, band2.bwd_launches)
    out, got = _grads(lambda *a: band2.band2_attention(
        *a, tpf, window, span, nrefs, logit_bound=bound), q, k, v, dout)
    torch.cuda.synchronize()
    assert (band2.fwd_launches, band2.bwd_launches) == \
        (counts[0] + 1, counts[1] + 1)
    ref, want = _grads(lambda *a: band2.band2_attention_plain(
        *a, tpf, window, bound), q.float(), k.float(), v.float(),
        dout.float())
    err = (out.float() - ref).abs()
    assert err.max().item() < 2e-2 and err.mean().item() < 2e-3
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a).all(), name
        assert _rel_l2(a, b) < GRAD_REL_L2, name


@pytest.mark.cuda
@pytest.mark.parametrize("kind,L,tpf,window,plan,bounded", [
    ("band", 1040, 65, 8, None, True), ("band", 2080, 65, 16, None, False),
    ("band2", 960, 65, 8, (192, 3), True),
    ("band2", 2080, 65, 16, (208, 5), False)])
def test_band_kernels_head_dim_128_match_plain_on_card(kind, L, tpf, window,
                                                       plan, bounded):
    """The band (K2/K3) and band2 (K5) kernels at Dh 128 (its scale
    128^-0.5 is no power of two, so q is rescaled in shared memory and the
    bound sqrt(128) is not folded) at lengths that are not a multiple of
    the 128-row tiles: forward and gradients against the plain version,
    one forward and one backward launch."""
    _need_card()
    q, k, v = _qkv(L, seed=13, normed=True, Dh=128)
    dout = _qkv(L, seed=14, Dh=128)[0]
    bound = 128 ** 0.5 if bounded else None
    mod = band if kind == "band" else band2
    extra = () if plan is None else plan
    counts = (mod.fwd_launches, mod.bwd_launches)
    out, got = _grads(lambda *a: getattr(mod, f"{kind}_attention")(
        *a, tpf, window, *extra, logit_bound=bound), q, k, v, dout)
    torch.cuda.synchronize()
    assert (mod.fwd_launches, mod.bwd_launches) == \
        (counts[0] + 1, counts[1] + 1)
    ref, want = _grads(lambda *a: getattr(mod, f"{kind}_attention_plain")(
        *a, tpf, window, bound), q.float(), k.float(), v.float(),
        dout.float())
    err = (out.float() - ref).abs()
    assert err.max().item() < 2e-2 and err.mean().item() < 2e-3
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a).all(), name
        assert _rel_l2(a, b) < GRAD_REL_L2, name


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["band", "band2"])
def test_band_kernels_read_strided_views_on_card(kind):
    """The band kernels read Attn's fused [B, H, L, Dh] views of the [B, L,
    3, H, Dh] projection in place (TMA tensor maps): the output and the
    gradients equal those of contiguous copies bit for bit; a view TMA
    cannot read is refused, not copied."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(15)
    B, H, Dh, tpf, window = 2, 4, 64, 65, 8
    # C = 520 must divide the band's L; band2's plan (192, 3) tiles 960
    L, args = ((1040, (tpf, window)) if kind == "band" else
               (960, (tpf, window, 192, 3)))
    fn = getattr(band if kind == "band" else band2, f"{kind}_attention")
    qkv = torch.randn(B, L, 3, H, Dh, generator=gen, device="cuda")
    qkv = (qkv * torch.rsqrt(qkv.pow(2).mean(-1, keepdim=True))).to(
        torch.bfloat16)
    leaf = qkv.detach().requires_grad_()
    views = [leaf[:, :, i].transpose(1, 2) for i in range(3)]
    out = fn(*views, *args, logit_bound=8.0)
    out.sum().backward()
    flat = [t.detach().contiguous().requires_grad_() for t in views]
    ref = fn(*flat, *args, logit_bound=8.0)
    ref.sum().backward()
    torch.cuda.synchronize()
    assert out.shape == (B, H, L, Dh)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    for i, t in enumerate(flat):
        torch.testing.assert_close(leaf.grad[:, :, i].transpose(1, 2),
                                   t.grad, atol=0, rtol=0)
    wide = torch.zeros(B, H, L, Dh + 4, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="^q: row stride"):
        fn(wide[..., :Dh], flat[1], flat[2], *args)


@pytest.mark.cuda
def test_kernel_reads_strided_views_and_rejects_what_it_cannot_run():
    _need_card()
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
    # TMA reads rows of 16-byte multiples: a view with 136-byte rows is
    # refused, not copied
    wide = torch.zeros(B, H, L, Dh + 4, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="^q: row stride"):
        splash.splash_attention(wide[..., :Dh], k, v, 65, 2, True)
    # a strided view that requires grad goes through the backward kernels,
    # which give the same gradients as on contiguous copies
    leaf = qkv.detach().requires_grad_()
    views = [leaf[:, :, i].transpose(1, 2) for i in range(3)]
    before = splash.dkv_launches
    splash.splash_attention(*views, 65, 2, True).sum().backward()
    flat = [t.detach().contiguous().requires_grad_() for t in (q, k, v)]
    splash.splash_attention(*flat, 65, 2, True).sum().backward()
    torch.cuda.synchronize()
    assert splash.dkv_launches == before + 2
    for i, t in enumerate(flat):
        torch.testing.assert_close(leaf.grad[:, :, i].transpose(1, 2),
                                   t.grad, atol=0, rtol=0)
    # a raw launch has no backward
    with pytest.raises(RuntimeError, match="require grad"):
        splash.frame_attention_cuda(views[0], views[1], views[2], 65, 2,
                                    True)


@pytest.mark.cuda
@pytest.mark.parametrize("L,tpf,window,causal,docs", [
    (455, 65, 2, False, True), (1000, 64, 3, True, True),
    (650, 65, None, True, False)])
def test_kernel_head_dim_128_matches_plain_on_card(L, tpf, window, causal,
                                                   docs):
    """K1 at Dh 128 (its scale 128^-0.5 is no power of two, so q is
    rescaled in shared memory) and at lengths that are not a multiple of
    the 128-row tiles, with documents and a window: forward and
    gradients against the plain version."""
    _need_card()
    q, k, v = _qkv(L, seed=11, Dh=128)
    dout = _qkv(L, seed=12, Dh=128)[0]
    nf = -(-L // tpf)
    doc = ((torch.arange(nf, device="cuda") >= nf // 3).int()[None]
           if docs else None)
    out, got = _grads(lambda *a: splash.splash_attention(
        *a, tpf, window, causal, doc), q, k, v, dout)
    ref, want = _grads(lambda *a: splash.splash_attention_plain(
        *a, tpf, window, causal, doc), q.float(), k.float(), v.float(),
        dout.float())
    torch.cuda.synchronize()
    err = (out.float() - ref).abs()
    assert err.max().item() < 2e-2 and err.mean().item() < 2e-3
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a).all(), name
        assert _rel_l2(a, b) < GRAD_REL_L2, name


@pytest.mark.cuda
@pytest.mark.parametrize("L,tpf,causal", [
    (1024, 64, True), (1024, 64, False), (650, 65, True), (650, 65, False),
    (1000, 64, True), (1000, 64, False), (455, 65, True), (455, 65, False)])
def test_ring_partial_matches_plain_on_card(L, tpf, causal):
    """K4: (out, lse) of pre-scaled q, and the backward through both
    outputs, against f32 autograd of the plain version."""
    _need_card()
    q, k, v = _qkv(L, seed=5, normed=True)
    q = (q * 64 ** -0.5).to(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(6)
    g_out = torch.randn(1, 4, L, 64, generator=gen, device="cuda")
    g_lse = torch.randn(1, 4, L, generator=gen, device="cuda")
    counts = (splash.lse_launches, splash.lse_dq_launches,
              splash.lse_dkv_launches, splash.launches)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out, lse = splash.splash_attention_lse(*leaves, tpf, causal)
    torch.autograd.backward((out, lse), (g_out, g_lse))
    torch.cuda.synchronize()
    assert (splash.lse_launches, splash.lse_dq_launches,
            splash.lse_dkv_launches, splash.launches) == \
        (counts[0] + 1, counts[1] + 1, counts[2] + 1, counts[3])
    assert out.dtype == lse.dtype == torch.float32
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    rout, rlse = splash.splash_attention_lse_plain(*ref, tpf, causal)
    torch.autograd.backward((rout, rlse), (g_out, g_lse))
    err = (out - rout).abs()
    assert err.max().item() < 2e-2 and err.mean().item() < 2e-3
    assert (lse - rlse).abs().max().item() < 2e-2
    for name, a, b in zip(("dq", "dk", "dv"), leaves, ref):
        assert torch.isfinite(a.grad).all(), name
        assert _rel_l2(a.grad, b.grad) < GRAD_REL_L2, name


@pytest.mark.cuda
@pytest.mark.parametrize("L,tpf,causal,Dh", [
    (1000, 64, True, 64), (1000, 64, False, 64), (455, 65, True, 64),
    (455, 65, False, 64), (1000, 64, True, 128), (1000, 64, False, 128),
    (455, 65, True, 128), (455, 65, False, 128)])
def test_ring_partial_vjp_matches_plain_on_card(L, tpf, causal, Dh):
    """K4's entry points called directly, as parallel/context.py calls
    them: splash_attention_lse (forward) and splash_attention_lse_vjp (dq
    and dkv on delta' with a non-zero lse cotangent), at lengths that are
    not a multiple of the 128-row tiles, at both head dims."""
    _need_card()
    q, k, v = _qkv(L, seed=9, normed=True, Dh=Dh)
    q = (q * Dh ** -0.5).to(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(10)
    g_out = torch.randn(1, 4, L, Dh, generator=gen, device="cuda")
    g_lse = torch.randn(1, 4, L, generator=gen, device="cuda")
    counts = (splash.lse_launches, splash.lse_dq_launches,
              splash.lse_dkv_launches)
    out, lse = splash.splash_attention_lse(q, k, v, tpf, causal)
    got = splash.splash_attention_lse_vjp(q, k, v, out, lse, g_out, g_lse,
                                          tpf, causal)
    torch.cuda.synchronize()
    assert (splash.lse_launches, splash.lse_dq_launches,
            splash.lse_dkv_launches) == tuple(c + 1 for c in counts)
    rout, rlse = splash.splash_attention_lse_plain(q.float(), k.float(),
                                                   v.float(), tpf, causal)
    want = splash.splash_attention_lse_vjp_plain(
        q.float(), k.float(), v.float(), rout, rlse, g_out, g_lse, tpf,
        causal)
    assert (out - rout).abs().max().item() < 2e-2
    assert (lse - rlse).abs().max().item() < 2e-2
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a).all(), name
        assert _rel_l2(a, b) < GRAD_REL_L2, name


@pytest.mark.cuda
def test_ring_and_halo_in_one_process_match_the_full_sequence_on_card():
    """The ring's and the halo's per-step functions over 4 slices in one
    process (K/V rotated by indexing; chip_smoke.py's harness at a small
    size) against K1 and the band kernel over the whole sequence, forward
    and gradients; K4 launches exact."""
    import chip_smoke
    _need_card()
    n, tpf, window = 4, 64, 2
    L = n * 2 * window * tpf
    q, k, v = _qkv(L, seed=7, normed=True)
    dout = _qkv(L, seed=8)[0]
    ring = lambda *t: chip_smoke.ring_one_process(*t, tpf, n)
    halo = lambda *t: chip_smoke.halo_one_process(*t, tpf, window, n, 8.0)

    before = splash.lse_launches, splash.lse_dq_launches
    ring_out, ring_grads = _grads(ring, q, k, v, dout)
    torch.cuda.synchronize()
    assert splash.lse_launches - before[0] == n * n + n * (n - 1)
    assert splash.lse_dq_launches - before[1] == n * n
    full_out, full_grads = _grads(lambda *a: splash.splash_attention(
        *a, tpf, None, True), q, k, v, dout)
    halo_out, halo_grads = _grads(halo, q, k, v, dout)
    band_out, band_grads = _grads(lambda *a: band.band_attention(
        *a, tpf, window, logit_bound=8.0), q, k, v, dout)
    for a, b in ((ring_out, full_out), (halo_out, band_out)):
        assert _rel_l2(a, b) < GRAD_REL_L2
    for got, want in ((ring_grads, full_grads), (halo_grads, band_grads)):
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            assert _rel_l2(a, b) < GRAD_REL_L2, name


@pytest.mark.cuda
def test_kernel_on_another_card_keeps_the_callers_device():
    """The K1/K4 entry points bind q's card for their launch and hand the
    calling thread its own current device back."""
    _need_card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs: a launch on a card that is not current")
    gen = torch.Generator(device="cuda:1").manual_seed(13)
    q, k, v = (torch.randn(1, 2, 260, 64, generator=gen, device="cuda:1")
               .to(torch.bfloat16) for _ in range(3))
    with torch.cuda.device(0):
        out = splash.splash_attention(q, k, v, 65, 2, True)
        lse_out, _ = splash.splash_attention_lse(q, k, v, 65, True)
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(1)
    ref = splash.splash_attention_plain(q.float(), k.float(), v.float(), 65,
                                        2, True)
    assert (out.float() - ref).abs().max().item() < 2e-2
    assert torch.isfinite(lse_out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("fused_write,kv_quant", [(True, None),
                                                  (False, "int8")])
def test_graphed_token_step_matches_the_eager_step(fused_write, kv_quant):
    """The audio sampler's CUDA-graph token loop (sampling/audio_caching.py)
    against the same step run eagerly, on the same draws, at a small width:
    a rolling ring that evicts, with a RoPE rebase between two segments.
    Identical output is expected; cuBLAS may pick other algorithms under
    capture, so the bound is 1e-2 (chip_smoke.py's)."""
    _need_card()
    from owl_audio_exps_tpu_torch.configs import transformer_config
    from owl_audio_exps_tpu_torch.models.audiorft import AudioRFTCore
    from owl_audio_exps_tpu_torch.sampling.audio_caching import (
        AudioCachingSampler, draw_noise)
    cfg = transformer_config(
        model_id="audio_rft", n_layers=4, n_heads=4, d_model=128,
        channels=16, tokens_per_frame=1, n_frames=16, rope_headroom=16,
        causal=True, uncond=True, has_audio=True, rope_impl="audio1d",
        local_window=4, global_window=None, local_idx=2, kv_quant=kv_quant)
    core = AudioRFTCore(cfg, dtype=torch.bfloat16, device="cuda",
                        seed=0).to(torch.bfloat16)
    sampler = AudioCachingSampler(n_steps=2, num_tokens=40,
                                  custom_schedule=[1.0, 0.5], max_window=12,
                                  fused_write=fused_write)
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(2, 12, 16, generator=gen, device="cuda").to(
        torch.bfloat16)
    noise = draw_noise(gen, 2, 12, 16, 40, "cuda")
    graphed = sampler(core, x, noise=noise)
    eager = sampler.sample_eager(core, x, noise=noise)
    again = sampler(core, x, noise=noise)     # replays the captured step
    torch.cuda.synchronize()
    loop = next(iter(sampler._loops.values()))[1]
    assert loop.graph is not None
    assert graphed.shape == (2, 52, 16) and torch.isfinite(graphed).all()
    assert (graphed.float() - eager.float()).abs().max().item() <= 1e-2
    assert torch.equal(graphed, again)


@pytest.mark.cuda
@pytest.mark.parametrize("n_sessions", [1, 2])
def test_graphed_steady_tick_matches_the_eager_tick(n_sessions):
    """The cached AV serve's steady tick replayed from its CUDA graph
    (inference/pipeline.py) against the same tick run eagerly, on the same
    draws (two pipelines seeded alike), at a small width: past the ring's
    capacity and across RoPE rebases. Identical output is expected; cuBLAS
    may pick other algorithms under capture, so the bound is 1e-2
    (chip_smoke.py's)."""
    _need_card()
    import numpy as np
    from owl_audio_exps_tpu_torch.configs import transformer_config
    from owl_audio_exps_tpu_torch.inference.pipeline import (
        AVCachedStreamingPipeline)
    from owl_audio_exps_tpu_torch.models.gamerft_audio import (
        GameRFTAudioCore)
    cfg = transformer_config(
        model_id="game_rft_audio", n_layers=4, n_heads=4, d_model=128,
        channels=16, audio_channels=8, sample_size=2, tokens_per_frame=5,
        n_frames=8, rope_headroom=8, n_buttons=3, causal=True, has_audio=True,
        local_window=2, global_window=None, local_idx=2)
    core = GameRFTAudioCore(cfg, dtype=torch.bfloat16, device="cuda",
                            seed=0).to(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(2)
    ctx = (torch.randn(n_sessions, 3, 16, 2, 2, generator=gen,
                       device="cuda"),
           torch.randn(n_sessions, 3, 8, generator=gen, device="cuda"),
           torch.zeros(n_sessions, 3, 2, device="cuda"),
           torch.zeros(n_sessions, 3, 3, device="cuda"))
    pipes = [AVCachedStreamingPipeline(core, cfg, window_frames=6,
                                       sampling_steps=2, seed=4,
                                       n_sessions=n_sessions, graphed=g)
             for g in (True, False)]
    for p in pipes:
        p.prime(*ctx)
    rs = np.random.RandomState(0)
    for i in range(24):
        mouse = rs.randn(n_sessions, 2).astype(np.float32)
        btn = (rs.rand(n_sessions, 3) > 0.5).astype(np.float32)
        (fg, ag, _), (fe, ae, _) = (p(mouse, btn) for p in pipes)
        assert torch.isfinite(fg.float()).all()
        for got, want in ((fg, fe), (ag, ae)):
            assert (got.float() - want.float()).abs().max().item() <= 1e-2
    assert pipes[0].loop.graphs and not pipes[1].loop.graphs
    assert int(pipes[0].cache.rope_offset) == int(pipes[1].cache.rope_offset)


# ------------------------------------------------------ decode attention

def _serve_ring(B, H, Dh, length, start, dtype=torch.bfloat16):
    """The AV serve's single ring (120 frames of 65 tokens, a 16-frame
    shadow) with every slot drawn, at ``length`` tokens from ``start``."""
    from owl_audio_exps_tpu_torch.nn.kv_cache import KVCache
    gen = torch.Generator(device="cuda").manual_seed(7)
    c = KVCache.create(n_layers=2, batch_size=B, capacity=7800, n_heads=H,
                       head_dim=Dh, tokens_per_frame=65, dtype=dtype,
                       shadow=1040, device="cuda")
    for buf in (c.k, c.v):
        buf.copy_(torch.randn(buf.shape, generator=gen, device="cuda"))
    c.start.fill_(start)
    c.length.fill_(length)
    c.rope_offset.fill_(length)
    return c


@pytest.mark.cuda
@pytest.mark.parametrize("kind,B,H,Dh,lq,length,dtype", [
    ("global_steady", 1, 24, 64, 130, 7800, torch.bfloat16),
    ("local_steady", 1, 24, 64, 130, 7800, torch.bfloat16),
    ("global_decode", 1, 24, 64, 65, 7800, torch.bfloat16),
    ("local_decode", 1, 24, 64, 65, 7800, torch.bfloat16),
    ("global_steady", 8, 24, 64, 130, 7800, torch.bfloat16),
    ("global_steady", 1, 12, 128, 130, 3000, torch.bfloat16),
    ("local_decode", 2, 12, 128, 65, 500, torch.float16),
    ("global_prime", 1, 24, 64, 7735, 0, torch.bfloat16)])
def test_decode_kernel_matches_plain_on_card(kind, B, H, Dh, lq, length,
                                             dtype):
    """The decode kernel at the serve's shapes (av_v5: a 120-frame ring of
    8,840 slots with its shadow; the steady forward's 130 queries, the
    decoding forward's 65, the prime's 7,735) against its plain version on
    the same operands, and bit for bit against itself. Limits: those of
    chip_smoke.py's decode rows (``DECODE_MAX_ABS``, ``DECODE_MEAN_ABS``),
    set from what the kernel reads against its plain version there: a
    few elements a bf16 step apart, the largest 1.95e-3 at the prime, the
    mean under 2e-7."""
    _need_card()
    from owl_audio_exps_tpu_torch.configs import transformer_config
    from owl_audio_exps_tpu_torch.nn.attn import build_masks
    from owl_audio_exps_tpu_torch.ops import decode_attention as da
    cfg = transformer_config(tokens_per_frame=65, local_window=16,
                             global_window=None, causal=True, n_frames=120)
    c = _serve_ring(B, H, Dh, length, 1235 if length == 7800 else 0, dtype)
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, nk, nv = (torch.randn(B, H, lq, Dh, generator=gen, device="cuda")
                 .to(dtype) for _ in range(3))
    if kind == "local_decode":
        ck, cv, valid = c.gather_trailing(1, 1040 - lq, local=True)
        mask = torch.cat([valid, torch.ones(lq, dtype=torch.bool,
                                            device="cuda")])[None, :]
    else:
        local, glob = build_masks(
            cfg, lq, None, kv_cache=c, decoding=kind == "global_decode",
            write_len=65 if kind.endswith("steady") else None)
        mask = local if kind == "local_steady" else glob
        ck, cv = c.read_layer(0)
    before = da.launches
    out = da.decode_attention(q, ck, cv, nk, nv, mask)
    again = da.decode_attention(q, ck, cv, nk, nv, mask)
    torch.cuda.synchronize()
    rows, nq = da.query_tiling(lq)
    ns = da.split_count(B * H * nq, da.key_tiles(ck.shape[2], lq)[1],
                        da._sms(0))
    # the plan, pass 1, pass 2 and, with more than one split, their sum
    assert da.launches == before + 2 * (3 + (ns > 1))
    assert torch.equal(out, again)
    ref = da.decode_attention_plain(q, ck, cv, nk, nv, mask)
    err = (out.float() - ref.float()).abs()
    assert torch.isfinite(out).all()
    reading = (err.max().item(), err.mean().item())
    assert reading[0] < 4e-3 and reading[1] < 2e-6, reading


@pytest.mark.cuda
def test_decode_kernel_carries_the_graphed_steady_tick():
    """The cached AV serve at Dh 64 (the kernel's width): every attention
    call of the steady tick takes the kernel and none is dense. A tick is
    2 forwards x 4 layers = 8 calls of 4 launches (the plan, pass 1, pass
    2, the splits' sum). The graphed tick matches the eager one (cuBLAS may
    pick other algorithms under capture: chip_smoke.py's 1e-2)."""
    _need_card()
    import numpy as np
    from owl_audio_exps_tpu_torch.configs import transformer_config
    from owl_audio_exps_tpu_torch.inference.pipeline import (
        AVCachedStreamingPipeline)
    from owl_audio_exps_tpu_torch.models.gamerft_audio import (
        GameRFTAudioCore)
    from owl_audio_exps_tpu_torch.nn import attn
    from owl_audio_exps_tpu_torch.ops import decode_attention as da
    cfg = transformer_config(
        model_id="game_rft_audio", n_layers=4, n_heads=2, d_model=128,
        channels=16, audio_channels=8, sample_size=8, tokens_per_frame=65,
        n_frames=16, rope_headroom=16, n_buttons=3, causal=True,
        has_audio=True, local_window=4, global_window=None, local_idx=2)
    core = GameRFTAudioCore(cfg, dtype=torch.bfloat16, device="cuda",
                            seed=0).to(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(2)
    ctx = (torch.randn(1, 6, 16, 8, 8, generator=gen, device="cuda"),
           torch.randn(1, 6, 8, generator=gen, device="cuda"),
           torch.zeros(1, 6, 2, device="cuda"),
           torch.zeros(1, 6, 3, device="cuda"))
    pipes = [AVCachedStreamingPipeline(core, cfg, window_frames=12,
                                       sampling_steps=2, seed=4, graphed=g)
             for g in (True, False)]
    for p in pipes:
        p.prime(*ctx)
    rs = np.random.RandomState(0)
    for i in range(20):
        mouse = rs.randn(2).astype(np.float32)
        btn = (rs.rand(3) > 0.5).astype(np.float32)
        d0 = attn.dense_calls
        fg, ag, _ = pipes[0](mouse, btn)
        l0 = da.launches
        fe, ae, _ = pipes[1](mouse, btn)
        assert attn.dense_calls == d0
        assert da.launches - l0 == 8 * 4
        for got, want in ((fg, fe), (ag, ae)):
            assert torch.isfinite(got.float()).all()
            assert (got.float() - want.float()).abs().max().item() <= 1e-2
    assert pipes[0].loop.graphs and not pipes[1].loop.graphs
