"""The plain reference against the port at small sizes on the CPU, both
in float32: the two models' forwards (documents, windows, controls),
the blocked attention's gradients against autograd of a dense one, the
serve loop tick by tick through RoPE rebases, one optimizer step, and
the batches worked out again against the port's loaders."""

import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench.reference.model import (Model, Prec, blocked_attention,  # noqa
                                       frame_visibility, param_spec,
                                       train_attend)
from perfbench.weights import load_into, make_weights  # noqa: E402

SMALL = dict(sample_size=2, channels=8, audio_channels=6, n_layers=5,
             n_heads=2, d_model=32, n_buttons=3, n_mouse_axes=2,
             cfg_prob=0.0, n_frames=6, causal=True, uncond=False,
             backbone="dit", local_window=2, global_window=None,
             attn_impl="dense")


def small(audio):
    m = dict(SMALL, has_audio=audio,
             model_id="game_rft_audio" if audio else "game_rft",
             tokens_per_frame=5 if audio else 4,
             rope_impl="ortho" if audio else "motion")
    return m


def port_config(m, train=None):
    from owl_audio_exps_tpu_torch.configs import Config
    return Config.from_dict({"model": m, "train": train or {}})


@pytest.mark.parametrize("audio", [False, True])
def test_rope_tables_match_the_port(audio):
    from owl_audio_exps_tpu_torch.ops.rope import get_rope_freqs
    from perfbench.reference.rope import angles
    m = dict(small(audio), rope_headroom=6)
    np.testing.assert_array_equal(get_rope_freqs(port_config(m).model),
                                  angles(m, 12))


@pytest.mark.parametrize("audio", [False, True])
def test_forward_matches_the_port(audio):
    from owl_audio_exps_tpu_torch.models.gamerft import GameRFT
    from owl_audio_exps_tpu_torch.models.gamerft_audio import GameRFTAudio
    m = small(audio)
    cls = GameRFTAudio if audio else GameRFT
    model = cls(port_config(m).model, dtype=torch.float32, device="cpu",
                seed=None)
    w = make_weights(param_spec(m, "core."), 5, torch.float32, "cpu")
    load_into(model, w)
    g = torch.Generator().manual_seed(0)
    b, n = 2, 6
    x = torch.randn(b, n, 8, 2, 2, generator=g)
    mouse = torch.randn(b, n, 2, generator=g)
    btn = (torch.rand(b, n, 3, generator=g) > .5).float()
    t = torch.rand(b, n, generator=g)
    hc = torch.tensor([True, False])
    ref = Model(m, w, prefix="core.")
    L = n * m["tokens_per_frame"]
    if audio:
        au = torch.randn(b, n, 6, generator=g)
        got = model.core(x, au, t, mouse, btn, hc)
        want = ref.av(x, au, t, mouse, btn, hc,
                      train_attend(m, L, None, Prec(), "cpu"))
    else:
        doc = torch.tensor([[0, 0, 0, 1, 1, 1], [0, 1, 1, 1, 1, 2]],
                           dtype=torch.int32)
        got = (model.core(x, t, mouse, btn, doc, hc),)
        want = (ref.video(x, t, mouse, btn, hc,
                          train_attend(m, L, doc, Prec(), "cpu")),)
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("budget", [24, 96, 2 ** 20])
def test_blocked_attention_matches_dense_autograd(budget):
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 3, 24, 8, dtype=torch.float64, generator=g,
                           requires_grad=True) for _ in range(3))
    doc = torch.tensor([[0, 0, 1, 1, 1, 2], [0, 0, 0, 0, 1, 1]])
    vis = frame_visibility(6, 3, True, doc)
    out = blocked_attention(q, k, v, vis, 4, budget=budget)
    mask = vis.repeat_interleave(4, 1).repeat_interleave(4, 2)[:, None]
    s = (q @ k.transpose(-1, -2)) * 8 ** -0.5
    dense = torch.softmax(s.masked_fill(~mask, float("-inf")), -1) @ v
    torch.testing.assert_close(out, dense)
    gout = torch.randn(out.shape, dtype=torch.float64, generator=g)
    for a, b in zip(torch.autograd.grad(out, (q, k, v), gout),
                    torch.autograd.grad(dense, (q, k, v), gout)):
        torch.testing.assert_close(a, b)


def serve_pair(window=3):
    from owl_audio_exps_tpu_torch.inference.pipeline import (
        AVCachedStreamingPipeline)
    from owl_audio_exps_tpu_torch.models.gamerft_audio import (
        GameRFTAudioCore)
    from perfbench.reference.serve import ServeReference
    m = dict(small(True), local_window=3, n_frames=4, rope_headroom=12)
    core = GameRFTAudioCore(port_config(m).model, dtype=torch.float32,
                            device="cpu", seed=None)
    w = make_weights(param_spec(m), 9, torch.float32, "cpu")
    load_into(core, w)
    pipe = AVCachedStreamingPipeline(core, port_config(m).model,
                                     window_frames=8, sampling_steps=2,
                                     n_sessions=1, fused_write=True,
                                     device="cpu", graphed=False)
    ref = ServeReference(dict(m, local_window=window), w, 8, 0.2,
                         max_frames=200, device="cpu")
    return pipe, ref


def serve_errors(pipe, ref, ticks=40):
    from owl_audio_exps_tpu_torch.inference.pipeline import TickNoise
    g = torch.Generator().manual_seed(2)

    def bf(x):
        return x.to(torch.bfloat16).float()

    T = 8
    lat, aud = torch.randn(1, T, 8, 2, 2, generator=g), \
        torch.randn(1, T, 6, generator=g)
    mouse = bf(torch.randn(1, T, 2, generator=g))
    btn = (torch.rand(1, T, 3, generator=g) > .5).float()
    zl, za = torch.randn(1, T, 8, 2, 2, generator=g), \
        torch.randn(1, T, 6, generator=g)
    pipe.prime(lat, aud, mouse, btn, noise=(zl, za))
    ref.prime(lat, aud, mouse, btn, zl, za)
    errs, rebased = [], False
    for _ in range(ticks):
        mo = bf(torch.randn(1, 1, 2, generator=g))
        bt = (torch.rand(1, 1, 3, generator=g) > .5).float()
        zi = (torch.randn(1, 1, 8, 2, 2, generator=g),
              torch.randn(1, 1, 6, generator=g))
        zr = (torch.randn(1, 1, 8, 2, 2, generator=g),
              torch.randn(1, 1, 6, generator=g))
        off = pipe._off_frames
        f, a, _ = pipe(mo[0, 0].numpy(), bt[0, 0].numpy(), TickNoise(zi, zr))
        rebased = rebased or pipe._off_frames < off + 1
        rf, ra = ref.tick(mo, bt, zi, zr)
        errs.append(max(float((f.float() - rf).norm() / rf.norm()),
                        float((a.float() - ra).norm() / ra.norm())))
    return errs, rebased


def test_serve_reference_follows_the_cached_pipeline():
    """The pipeline keeps latents and rings in bfloat16 whatever the
    core's dtype, so it agrees within bfloat16 rounding; a window one
    frame too wide in the reference reads ten times that."""
    errs, rebased = serve_errors(*serve_pair())
    assert rebased
    assert max(errs) < 1e-2
    wrong, _ = serve_errors(*serve_pair(window=4))
    assert max(wrong) > 3 * max(errs)


def test_optimizer_step_matches_the_port():
    from owl_audio_exps_tpu_torch.muon import init_muon
    from perfbench.reference.optim import Optimizer
    kw = dict(lr=1e-3, momentum=0.95, adamw_lr=1e-4, adamw_wd=1e-4,
              adamw_eps=1e-15, adamw_betas=[0.9, 0.95],
              adamw_keys=["proj_in"])
    g = torch.Generator().manual_seed(3)
    shapes = {"proj_in.weight": (16, 8), "blocks.0.qkv.weight": (48, 16),
              "blocks.0.qkv.bias": (48,), "blocks.0.out.weight": (16, 16)}
    p0 = {n: torch.randn(s, generator=g) for n, s in shapes.items()}
    grads = [{n: torch.randn(s, generator=g) for n, s in shapes.items()}
             for _ in range(3)]
    port = {n: torch.nn.Parameter(t.clone()) for n, t in p0.items()}
    opt = init_muon(list(port.items()), **kw)
    ref = {n: t.clone() for n, t in p0.items()}
    ropt = Optimizer(ref, kw)
    for gr in grads:
        for n, p in port.items():
            p.grad = gr[n].clone()
        opt.step()
        ropt.step(gr)
    for n in shapes:
        a, b = port[n].detach() - p0[n], ref[n] - p0[n]
        tol = 1e-6 if "bias" in n or "proj_in" in n else 3e-2
        assert float((a - b).norm() / b.norm()) < tol, n


def test_packed_batches_match_the_port_loader(tmp_path):
    from owl_audio_exps_tpu_torch.data import get_loader
    from owl_audio_exps_tpu_torch.data.npy_table import NpyTable
    from perfbench.drivers.train import doc_lengths, make_docs
    from perfbench.reference.data import packed_batches
    mc = dict(sample_size=2, channels=3, n_buttons=2)
    lengths = doc_lengths({"low": 3, "high": 9, "count": 7, "seed": 4})
    docs = make_docs(mc, lengths, 11, torch.device("cpu"))
    table = NpyTable(str(tmp_path), columns=[
        "video", "mouse", "buttons", "tarball", "pt_idx", "missing",
        "truncated", "seq_len"], array_columns=["video", "mouse", "buttons"])
    for i, d in enumerate(docs):
        table.append(video=d["video"], mouse=d["mouse"], buttons=d["buttons"],
                     tarball=f"d{i}", pt_idx=i, missing=False,
                     truncated=False, seq_len=len(d["video"]))
    it = iter(get_loader("sequence_packing", 1, dataset_path=str(tmp_path),
                         window_length=5,
                         batch_columns=["video", "mouse", "buttons"]))
    n = 2 * (sum(lengths) // 5) + 1   # into the third epoch
    for got, want in zip((next(it) for _ in range(n)),
                         packed_batches(docs, 5, n)):
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("data_id,audio", [("synthetic_latent", False),
                                           ("synthetic_av", True)])
def test_synthetic_batches_match_the_port_loader(data_id, audio):
    from owl_audio_exps_tpu_torch.data import get_loader
    from perfbench.drivers.train import synthetic_seed, synthetic_shapes
    from perfbench.reference.data import synthetic_batches
    mc = dict(sample_size=2, channels=3, audio_channels=4, n_buttons=2,
              has_audio=audio)
    seed = 2 ** 31 + 77
    it = iter(get_loader(data_id, 2, window_length=3, channels=3,
                         audio_channels=4, sample_size=2, n_buttons=2,
                         process_index=synthetic_seed(seed)))
    want = synthetic_batches(1000 + synthetic_seed(seed),
                             synthetic_shapes(mc, {"batch_size": 2}, 3), 3)
    for w in want:
        for a, b in zip(next(it), w):
            np.testing.assert_array_equal(a, b)


def test_weights_fill_the_port_models_by_name():
    from owl_audio_exps_tpu_torch.models.gamerft_audio import GameRFTAudio
    m = small(True)
    model = GameRFTAudio(port_config(m).model, dtype=torch.float32,
                         device="cpu", seed=None)
    w = make_weights(param_spec(m, "core."), 1, torch.float32, "cpu")
    load_into(model, w)
    bad = copy.copy(w)
    bad.pop("core.proj_in.weight")
    with pytest.raises(ValueError):
        load_into(model, bad)
