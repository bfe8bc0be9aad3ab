"""The port's VAEs, its VAE bridge and the decoded serve against the JAX
package on the CPU: the audio VAE (nn/audio_vae.py) and the DC-AE decoder
(nn/dcae.py) on weights carried from JAX by ``vae_params_from_jax``, both
forms of the audio decoder's transposed convolution, the torch mirrors'
state_dicts loaded strict, the full-width decoder's parameter count, the
bridge's batched functions, a serve pipeline decoding through DC-AE, and
the headless game loop.

Float32 comparisons of the same weights are held to rtol 1e-4 (atol
1e-5): the two frameworks sum convolutions in other orders. The bridge
runs bf16 as the JAX bridge does; a bf16 path is held to a relative L2
of 2e-2 (a few bf16 roundings, 2^-8 each, through the stack)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_audio_exps_tpu.nn.audio_vae import AudioVAE as JaxAudioVAE
from owl_audio_exps_tpu.nn.dcae import DCAEDecoder as JaxDCAE
from owl_audio_exps_tpu.nn.dcae import pixel_shuffle as jax_pixel_shuffle
from owl_audio_exps_tpu.utils import owl_vae_bridge as jax_bridge
from owl_audio_exps_tpu_torch.nn.audio_vae import AudioVAE, UpConv1d
from owl_audio_exps_tpu_torch.nn.dcae import DCAEDecoder, pixel_shuffle
from owl_audio_exps_tpu_torch.utils import owl_vae_bridge as bridge
from owl_audio_exps_tpu_torch.utils.weights import vae_params_from_jax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from audio_vae_torch_mirror import AudioVAE as MirrorAudioVAE  # noqa: E402
from dcae_torch_mirror import Decoder as MirrorDecoder  # noqa: E402
from torch_port_util import (jax_apply, jax_init,  # noqa: E402
                             jax_serve_pipelines, numpy_params)

RTOL, ATOL = 1e-4, 1e-5
BF16_REL_L2 = 2e-2
T = 735 * 4     # 4 latents
SMALL = dict(   # tests/test_dcae.py's widths
    latent_channels=8, block_out_channels=(16, 32, 64),
    block_types=("ResBlock", "ResBlock", "EfficientViTBlock"),
    layers_per_block=(1, 1, 1), qkv_multiscales=((), (), (5,)),
    attention_head_dim=16)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL, err_msg=what)


# ------------------------------------------------------------- audio VAE
@pytest.fixture(scope="module")
def audio_pair():
    """The JAX AudioVAE in float32 at key 0 and the port's on its weights."""
    x = (np.random.RandomState(0).randn(2, T, 2) * 0.5).astype(np.float32)
    jm, params = jax_init(JaxAudioVAE(64, dtype=jnp.float32), x[:1])
    pm = AudioVAE(64, dtype=torch.float32, device="cpu", seed=None)
    pm.load_state_dict(vae_params_from_jax(numpy_params(params)), strict=True)
    return jm, params, pm.eval(), x


@pytest.mark.parametrize("path", ["encode", "decode", "roundtrip"])
def test_audio_vae_matches_jax_on_carried_weights(audio_pair, path):
    jm, params, pm, x = audio_pair
    z = np.random.RandomState(1).randn(2, 4, 64).astype(np.float32)
    with torch.no_grad():
        if path == "encode":
            want = jax_apply(jm, params, x, method="encode")
            got = pm.encode(torch.from_numpy(x))
            assert tuple(got.shape) == (2, 4, 64)
        elif path == "decode":
            want = jax_apply(jm, params, z, method="decode")
            got = pm.decode(torch.from_numpy(z))
            assert tuple(got.shape) == (2, T, 2)
        else:
            want, want_z = jax_apply(jm, params, x)
            got, got_z = pm(torch.from_numpy(x))
            close(got_z, want_z, "latents")
    close(got, want, path)


@pytest.mark.parametrize("s", [3, 5, 7])
def test_conv_transpose_forms_agree(s):
    """The card's form (conv_transpose1d on the flipped kernel, cropped)
    against flax's as written (zero-dilated input, un-flipped
    correlation), float32: relative L2 within 1e-5 (reassociation)."""
    gen = torch.Generator().manual_seed(s)
    up = UpConv1d(16, 8, s, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        up.weight.normal_(generator=gen)
        up.bias.normal_(generator=gen)
        x = torch.randn(2, 16, 9, generator=gen)
        a, b = up(x), up.dilated(x)
    assert tuple(a.shape) == tuple(b.shape) == (2, 8, 9 * s)
    assert rel_l2(a, b) <= 1e-5


def test_mirror_state_dicts_load_strict():
    """The torch mirrors' state_dicts (the layouts the JAX importers read)
    load into the port's modules with strict=True and give the mirrors'
    outputs; a full AutoencoderDC state_dict (``decoder.`` keys beside the
    encoder's) gives the bare decoder's."""
    torch.manual_seed(0)
    mirror = MirrorAudioVAE().eval()
    pm = AudioVAE(64, dtype=torch.float32, device="cpu", seed=None).eval()
    pm.load_state_dict(mirror.state_dict(), strict=True)
    x = torch.from_numpy(
        np.random.RandomState(2).randn(1, T, 2).astype(np.float32) * 0.5)
    with torch.no_grad():
        for got, want in zip(pm(x), mirror(x)):
            close(got, want)

    mdec = MirrorDecoder(8, list(SMALL["block_out_channels"]),
                         list(SMALL["block_types"]),
                         list(SMALL["layers_per_block"]),
                         list(SMALL["qkv_multiscales"]), 16).eval()
    pd = DCAEDecoder(**SMALL, device="cpu", seed=None).eval()
    full = {f"decoder.{k}": v for k, v in mirror_sd(mdec).items()}
    full["encoder.conv_in.weight"] = torch.zeros(4, 4, 3, 3)
    pd.load_state_dict(bridge.decoder_state_dict(full), strict=True)
    z = torch.randn(2, 8, 4, 4, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        close(pd(z), mdec(z))


def mirror_sd(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


# ------------------------------------------------------------------ DCAE
@pytest.mark.parametrize("branch", ["linear", "quadratic"])
def test_dcae_matches_jax_on_carried_weights(branch):
    """tests/test_dcae.py's SMALL widths. The attention stage sees the
    latent's grid: the linear form runs where h * w > head_dim (a 4 x 4
    grid at head_dim 8), the quadratic form elsewhere (2 x 2 at 32)."""
    hd, hw = {"linear": (8, 4), "quadratic": (32, 2)}[branch]
    cfg = dict(SMALL, attention_head_dim=hd)
    z = np.random.RandomState(4).randn(2, 8, hw, hw).astype(np.float32)
    zh = np.transpose(z, (0, 2, 3, 1))
    jm, params = jax_init(JaxDCAE(**cfg), zh)
    want = np.transpose(np.asarray(jax_apply(jm, params, zh)), (0, 3, 1, 2))
    pm = DCAEDecoder(**cfg, device="cpu", seed=None).eval()
    pm.load_state_dict(vae_params_from_jax(numpy_params(params)), strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(z))
    assert tuple(got.shape) == (2, 3, 4 * hw, 4 * hw)
    assert got.is_contiguous(memory_format=torch.channels_last)
    close(got, want, branch)


def test_pixel_shuffle_matches_jax_and_torch():
    x = np.random.RandomState(0).randn(2, 12, 3, 4).astype(np.float32)
    got = pixel_shuffle(torch.from_numpy(x), 2)
    want = jax_pixel_shuffle(jnp.asarray(np.transpose(x, (0, 2, 3, 1))), 2)
    np.testing.assert_array_equal(
        got.numpy(), np.transpose(np.asarray(want), (0, 3, 1, 2)))
    np.testing.assert_array_equal(
        got.numpy(),
        torch.nn.functional.pixel_shuffle(torch.from_numpy(x), 2).numpy())


def test_full_width_decoder_on_the_meta_device():
    """The dc-ae-f64c128 widths at configs/causvid.yml's 64 latent
    channels: 208,114,691 parameters, as JAX's eval_shape counts, and an
    8 x 8 latent decodes to 256 x 256 x 3."""
    m = DCAEDecoder(latent_channels=64, device="meta", seed=None)
    n = sum(p.numel() for p in m.parameters())
    assert n == 208_114_691
    shapes = jax.eval_shape(JaxDCAE(latent_channels=64).init,
                            jax.random.key(0),
                            jnp.zeros((1, 8, 8, 64), jnp.bfloat16))
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    out = m(torch.zeros(1, 64, 8, 8, device="meta"))
    assert tuple(out.shape) == (1, 3, 256, 256)


# ---------------------------------------------------------------- bridge
def test_video_decoders_match_jax():
    """The bridge's bf16 decoders against the JAX bridge's on the same
    weights: the pixel-shuffle decoder (JAX's key-0 params carried) and
    DCAEVideoDecoder reading one torch checkpoint in both packages; both
    [b, H, W, 3] float32."""
    z = np.random.RandomState(5).randn(3, 8, 4, 4).astype(np.float32)
    jdec = jax_bridge.PixelShuffleVideoDecoder(latent_channels=8)
    pdec = bridge.PixelShuffleVideoDecoder(latent_channels=8, device="cpu")
    pdec.load_state_dict(vae_params_from_jax(numpy_params(jdec.params)),
                         strict=True)
    got, want = pdec(torch.from_numpy(z)), np.asarray(jdec(jnp.asarray(z)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 32, 32, 3)
    assert rel_l2(got, want) <= BF16_REL_L2


def test_dcae_video_decoder_reads_a_torch_checkpoint(tmp_path):
    torch.manual_seed(6)
    mdec = MirrorDecoder(8, list(SMALL["block_out_channels"]),
                         list(SMALL["block_types"]),
                         list(SMALL["layers_per_block"]),
                         list(SMALL["qkv_multiscales"]), 16).eval()
    path = str(tmp_path / "dcae.pt")
    torch.save({f"decoder.{k}": v for k, v in mirror_sd(mdec).items()},
               path)
    rest = {k: v for k, v in SMALL.items() if k != "latent_channels"}
    pdec = bridge.DCAEVideoDecoder(latent_channels=8, ckpt_path=path,
                                   device="cpu", **rest)
    jdec = jax_bridge.DCAEVideoDecoder(latent_channels=8, ckpt_path=path,
                                       **rest)
    z = np.random.RandomState(7).randn(2, 8, 4, 4).astype(np.float32)
    got = pdec(torch.from_numpy(z))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 16, 16, 3)
    assert rel_l2(got, np.asarray(jdec(jnp.asarray(z)))) <= BF16_REL_L2
    with torch.no_grad():
        ref = mdec(torch.from_numpy(z)).permute(0, 2, 3, 1)
    assert rel_l2(got, ref) <= BF16_REL_L2
    with pytest.raises(ValueError, match=r"\[b, c, h, w\]"):
        pdec(torch.zeros(8, 4, 4))


def test_orbax_checkpoints_are_refused(tmp_path):
    """The JAX bridge reads orbax directories at ckpt_path + "_enc" /
    "_dec"; without JAX the port names that and raises."""
    (tmp_path / "vae_enc").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        bridge.get_audio_encoder_decoder(ckpt_path=str(tmp_path / "vae"),
                                         device="cpu")


@pytest.mark.parametrize("what", ["decode", "encode"])
def test_batched_audio_functions_match_jax(what):
    """The bridge's batched audio functions (JAX package's and port's)
    around float32 VAEs on the same weights, 3 rows at batch_size 2 across
    the 120-latent (88,200-sample) window: 121 latents."""
    x = (np.random.RandomState(8).randn(3, 121 * 735, 2) * 0.5
         ).astype(np.float32)
    jm, params = jax_init(JaxAudioVAE(64, dtype=jnp.float32), x[:1, :T])
    pm = AudioVAE(64, dtype=torch.float32, device="cpu", seed=None).eval()
    pm.load_state_dict(vae_params_from_jax(numpy_params(params)), strict=True)
    if what == "decode":
        inp = np.random.RandomState(9).randn(3, 121, 64).astype(np.float32)
        jfn = jax_bridge.make_batched_audio_decode_fn(
            lambda z: jax_apply(jm, params, z, method="decode"), 2)
        pfn = bridge.make_batched_audio_decode_fn(pm.decode, 2)
        shape = (3, 121 * 735, 2)
    else:
        inp = x
        jfn = jax_bridge.make_batched_audio_encode_fn(
            lambda w: jax_apply(jm, params, w, method="encode"), 2)
        pfn = bridge.make_batched_audio_encode_fn(pm.encode, 2)
        shape = (3, 121, 64)
    with torch.no_grad():
        got = pfn(torch.from_numpy(inp))
    assert tuple(got.shape) == shape
    close(got, jfn(jnp.asarray(inp)), what)


def test_batched_decode_and_the_bridge_defaults():
    """``make_batched_decode_fn`` flattens [b, n] and decodes
    ``batch_size`` frames at a time; the bridge's audio pair is bf16 in,
    float32 waveforms out, at the reference geometry."""
    calls = []

    def dec(z):
        calls.append(z.shape[0])
        return z.sum(1, keepdim=True).permute(0, 2, 3, 1) * 2

    z = torch.randn(2, 3, 4, 2, 2)
    out = bridge.make_batched_decode_fn(dec, batch_size=4)(z)
    assert calls == [4, 2] and tuple(out.shape) == (2, 3, 2, 2, 1)
    torch.testing.assert_close(out[1, 2, ..., 0], 2 * z[1, 2].sum(0))
    enc, dec = bridge.get_audio_encoder_decoder(device="cpu")
    lat = enc(torch.randn(1, 2 * 735, 2))
    assert lat.dtype == torch.bfloat16 and tuple(lat.shape) == (1, 2, 64)
    wf = dec(lat)
    assert wf.dtype == torch.float32 and tuple(wf.shape) == (1, 2 * 735, 2)
    assert float(wf.abs().max()) <= 1.0


# -------------------------------------------------------- decoded serve
def small_dcae(latent_channels=4):
    rest = {k: v for k, v in SMALL.items() if k != "latent_channels"}
    return bridge.DCAEVideoDecoder(latent_channels=latent_channels,
                                   device="cpu", **rest)


@pytest.mark.parametrize("kind", ["video", "av"])
def test_serve_pipeline_decodes_through_dcae(kind):
    """The port's counterpart of tests/test_dcae.py's
    test_serve_pipeline_decodes_through_dcae: a cached pipeline's tick
    decoded through DC-AE (SMALL widths) gives pixels [1, H, W, 3] (and
    with the audio decoder 735 stereo samples a session), equal to the
    decoders applied to the latents of an undecoded pipeline's tick on the
    same draws; over 2 sessions frames are [2, 1, H, W, 3] as the JAX
    pipelines shape them."""
    from torch_port_util import av_cores, video_cores
    from owl_audio_exps_tpu_torch.inference.pipeline import (
        AVCachedStreamingPipeline, CachedStreamingPipeline)
    cores = video_cores if kind == "video" else av_cores
    _, pcfg, _, _, core = cores()
    dec = small_dcae()
    _, adec = bridge.get_audio_encoder_decoder(latent_channels=4,
                                               device="cpu")
    fdec = bridge.make_batched_decode_fn(dec, batch_size=1)
    adec_b = bridge.make_batched_audio_decode_fn(adec)
    for B in (1, 2):
        kw = dict(window_frames=6, sampling_steps=2, seed=3, n_sessions=B,
                  device="cpu")
        if kind == "video":
            pipes = [CachedStreamingPipeline(core, pcfg, frame_decode_fn=fdec,
                                             **kw),
                     CachedStreamingPipeline(core, pcfg, **kw)]
        else:
            pipes = [AVCachedStreamingPipeline(
                core, pcfg, frame_decode_fn=fdec, audio_decode_fn=adec_b,
                image_scale=2.0, audio_scale=0.5, **kw),
                AVCachedStreamingPipeline(core, pcfg, **kw)]
        rs = np.random.RandomState(B)
        for tick in range(3):
            ctrl = (rs.randn(B, 2).astype(np.float32),
                    (rs.rand(B, 3) > 0.5).astype(np.float32))
            (frame, audio, _), (lat, alat, _) = (p(*ctrl) for p in pipes)
            want = fdec(lat[:, None] * (2.0 if kind == "av" else 1.0))
            want = want[0] if B == 1 else want
            torch.testing.assert_close(frame, want, rtol=0, atol=0)
            shape = (1, 8, 8, 3) if B == 1 else (B, 1, 8, 8, 3)
            assert tuple(frame.shape) == shape
            assert torch.isfinite(frame).all()
            if kind == "av":
                torch.testing.assert_close(audio, adec_b(alat[:, None] * 0.5),
                                           rtol=0, atol=0)
                assert tuple(audio.shape) == (B, 735, 2)
                assert audio.dtype == torch.float32


def test_window_pipeline_decode_fails_in_both_packages():
    """The JAX CausvidPipeline hands its frame decoder the latent [1, c,
    h, w]; make_batched_decode_fn reads that as [b, n, ...] and the
    decoder receives [1, h, w]: the JAX tick raises, and the port keeps
    the reference's behaviour (ValueError naming the shape). A decoder
    that takes [1, c, h, w] decodes. (The JAX decoder fails on the input's
    rank before it reads a weight, so it is made without its init.)"""
    from torch_port_util import av_cores
    from owl_audio_exps_tpu_torch.inference.pipeline import CausvidPipeline
    jcfg, pcfg, jcore, params, core = av_cores(causal=True)
    jdec = jax_bridge.DCAEVideoDecoder.__new__(jax_bridge.DCAEVideoDecoder)
    jp = jax_serve_pipelines().CausvidPipeline(
        jcore, params, jcfg, window_length=3,
        frame_decode_fn=jax_bridge.make_batched_decode_fn(jdec, 1))
    with pytest.raises(ValueError, match="out of bounds"):
        jp(np.zeros(2, np.float32), np.zeros(3, np.float32))
    dec = small_dcae()
    pp = CausvidPipeline(core, pcfg, window_length=3, device="cpu",
                         frame_decode_fn=bridge.make_batched_decode_fn(dec,
                                                                       1))
    with pytest.raises(ValueError, match=r"got shape \(1, 2, 2\)"):
        pp(np.zeros(2), np.zeros(3))
    pp.frame_decode_fn = dec
    frame, _, _ = pp(np.zeros(2), np.zeros(3))
    assert tuple(frame.shape) == (8, 8, 3)


# ------------------------------------------------------------- game loop
class FakeBackend:
    def __init__(self, scripted_events=(), pointer_path=((0, 0),)):
        self.scripted = list(scripted_events)
        self.pointer_path = list(pointer_path)
        self.blits = []
        self.closed = False

    def poll_events(self):
        return self.scripted.pop(0) if self.scripted else []

    def query_pointer(self):
        if len(self.pointer_path) > 1:
            return self.pointer_path.pop(0)
        return self.pointer_path[0]

    def blit(self, frame):
        self.blits.append(np.asarray(frame))

    def close(self):
        self.closed = True


class FakePipeline:
    def __init__(self, frame):
        self.calls, self.frame = [], frame
        self.sampling_steps, self.resets, self.restarts = 4, 0, 0

    def __call__(self, mouse, btn):
        self.calls.append((np.asarray(mouse).copy(), np.asarray(btn).copy()))
        return self.frame, None, 0.001

    def init_buffers(self):
        self.resets += 1

    def restart_from_buffer(self):
        self.restarts += 1

    def up_sampling_steps(self):
        self.sampling_steps += 1

    def down_sampling_steps(self):
        self.sampling_steps -= 1


def test_game_loop_matches_the_jax_loop():
    """The same scripted keys, buttons and pointer through the JAX game
    loop and the port's: the same controls reach the pipeline, the same
    frames are blitted (the port's a tensor, moved to the host), the
    same control keys act, and both quit on q."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "inference"))
    import game_cv as jax_game
    from owl_audio_exps_tpu_torch.inference import game_cv as port_game
    assert (port_game.KEYMAP, port_game.BUTTONMAP, port_game.KEYBINDS) == \
        (jax_game.KEYMAP, jax_game.BUTTONMAP, jax_game.KEYBINDS)
    events = [[("key", "w", True), ("key", "o", True)],
              [("button", 3, True), ("key", "y", True)],
              [("key", "w", False), ("key", "i", True), ("key", "u", True)],
              [("key", "q", True)]]
    pointer = [(0, 0), (50, -20), (10000, 0)]
    frame = np.random.RandomState(0).rand(8, 8, 3).astype(np.float32)
    runs = []
    for mod, fr in ((jax_game, frame), (port_game, torch.from_numpy(frame))):
        pipe = FakePipeline(fr)
        backend = FakeBackend([list(e) for e in events], list(pointer))
        ticks = mod.GameCV(pipe, backend=backend, fps=1000).run(max_ticks=9)
        runs.append((ticks, pipe, backend))
    (tj, pj, bj), (tp, pp, bp) = runs
    assert tj == tp == 3 and bj.closed and bp.closed
    for (mj, bt_j), (mp, bt_p) in zip(pj.calls, pp.calls):
        np.testing.assert_array_equal(mj, mp)
        np.testing.assert_array_equal(bt_j, bt_p)
    np.testing.assert_allclose(pp.calls[1][0], [0.5, -0.2], atol=1e-6)
    assert pp.calls[1][1][10] == 1.0 and pp.calls[2][1][0] == 0.0
    assert (pj.sampling_steps, pj.resets, pj.restarts) == \
        (pp.sampling_steps, pp.resets, pp.restarts) == (4, 1, 1)
    for a, b in zip(bj.blits, bp.blits):
        np.testing.assert_array_equal(a, b)


def test_x11_backend_blit_packs_pixels_as_jax_does():
    from types import SimpleNamespace
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "inference"))
    import game_cv as jax_game
    from owl_audio_exps_tpu_torch.inference import game_cv as port_game

    class FakeWin:
        def __init__(self):
            self.puts = []

        def put_image(self, gc, x, y, w, h, fmt, depth, pad, data):
            self.puts.append((x, y, w, h, depth, data))

    frame = np.random.RandomState(1).randint(0, 256, (130, 4, 3),
                                             dtype=np.uint8)
    puts = []
    for mod in (jax_game, port_game):
        backend = mod.X11Backend.__new__(mod.X11Backend)
        backend._X = SimpleNamespace(ZPixmap=2)
        backend.width, backend.height = 4, 130   # 3 chunks: 64, 64, 2
        backend.win, backend.gc = FakeWin(), None
        backend.disp = SimpleNamespace(flush=lambda: None)
        backend.blit(frame)
        puts.append(backend.win.puts)
    assert puts[0] == puts[1] and len(puts[1]) == 3


@pytest.mark.parametrize("pipeline", ["cached", "window"])
def test_game_cv_main_runs_headless(pipeline, tmp_path):
    """``main`` at a tiny AV config (11 buttons, the loop's keymap) on the
    CPU: the cached pipeline
    decoding through the pixel-shuffle decoder (DC-AE's full width is the
    card's; chip_smoke runs it), the window pipeline undecoded."""
    import yaml
    from torch_port_util import AV
    from owl_audio_exps_tpu_torch.inference.game_cv import main
    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump({"model": dict(AV, causal=True,
                                                  n_buttons=11),
                                    "train": {"trainer_id": "av"}}))
    argv = ["--config_path", str(path), "--headless", "--ticks", "3",
            "--device", "cpu", "--pipeline", pipeline, "--window_frames", "12",
            "--fps", "1000"]
    if pipeline == "cached":
        argv += ["--vae", "pixel_shuffle"]
    assert main(argv) == 3
