"""The port's remaining helpers against the JAX package, on the CPU:
utils/profiling.py (``trace_if``, ``StepProfiler`` and its wiring into
the trainer's loop), the embeddings ``StepEmbedding``,
``ConditionEmbedding`` and ``LearnedPosEnc`` (parameters carried by
``params_from_jax``), ``l2_norm`` / ``gained_rms_norm``, ``freeze`` /
``find_unused_params``, ``latest_step_dir``, ``channel_gifs`` /
``wandb_video`` / ``wandb_audio``, ``detect_peak_tflops`` and
``is_quantized_kernel``.

Tolerances: float32 embeddings and norms rtol 1e-6 / atol 1e-6 (the same
float32 arithmetic in another order); bf16 norms within one bf16 step
(rtol 2 ** -7); names, files, counts and the profiled training state
exact.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_audio_exps_tpu.nn import embeddings as jemb
from owl_audio_exps_tpu.nn import wquant as jwquant
from owl_audio_exps_tpu.ops import norms as jnorms
from owl_audio_exps_tpu.utils import find_unused_params as jax_unused
from owl_audio_exps_tpu.utils import freeze as jax_freeze
from owl_audio_exps_tpu.utils import media as jmedia
from owl_audio_exps_tpu.utils import profiling as jprof
from owl_audio_exps_tpu.utils.checkpoints import \
    latest_step_dir as jax_latest
from owl_audio_exps_tpu_torch.configs import Config
from owl_audio_exps_tpu_torch.nn import embeddings as emb
from owl_audio_exps_tpu_torch.nn import wquant
from owl_audio_exps_tpu_torch.nn.layers import Linear
from owl_audio_exps_tpu_torch.ops import norms
from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
from owl_audio_exps_tpu_torch.utils import find_unused_params, freeze
from owl_audio_exps_tpu_torch.utils import media, mfu, profiling
from owl_audio_exps_tpu_torch.utils.checkpoints import latest_step_dir
from owl_audio_exps_tpu_torch.utils.weights import params_from_jax

from torch_port_util import jax_apply, jax_init, numpy_params


# ------------------------------------------------------------ profiling

def test_trace_if_noop(tmp_path):
    """tests/test_prefetch.py's spec: no directory, no trace; with one,
    one Chrome trace file."""
    with profiling.trace_if(None):
        pass
    p = profiling.StepProfiler(None)
    p.maybe_start(10)
    p.maybe_stop(13)
    assert p.path is None
    with profiling.trace_if(str(tmp_path / "t")):
        torch.ones(4).sum()
    (path,) = glob.glob(str(tmp_path / "t" / "rank0_*.pt.trace.json"))
    assert json.load(open(path))["traceEvents"]


def _jax_window(start, count, steps):
    """The steps at which JAX's StepProfiler starts and stops its trace
    over ``steps`` calls in the trainer's order (jax.profiler stubbed)."""
    events = []
    prof = jprof.StepProfiler("dir", start=start, count=count)
    real = jprof.jax.profiler
    stub = type("P", (), dict(
        start_trace=staticmethod(lambda d: events.append(("start", step))),
        stop_trace=staticmethod(lambda: events.append(("stop", step)))))
    jprof.jax.profiler = stub
    try:
        for step in range(steps):
            prof.maybe_start(step)
            prof.maybe_stop(step)
    finally:
        jprof.jax.profiler = real
    return events


def _tiny_rft(tmp_path, **train):
    return Config.from_dict({
        "model": dict(model_id="game_rft", n_layers=2, n_heads=2,
                      d_model=32, channels=4, sample_size=2,
                      tokens_per_frame=4, n_frames=4, n_buttons=3,
                      causal=True, uncond=False, has_audio=False,
                      rope_impl="ortho", local_window=2,
                      global_window=None, cfg_prob=0.1, backbone="dit"),
        "train": dict(dict(
            trainer_id="rft", data_id="synthetic_latent",
            data_kwargs=dict(window_length=4, channels=4, sample_size=2,
                             n_buttons=3),
            target_batch_size=1, batch_size=1, opt="AdamW",
            opt_kwargs=dict(lr=1e-3), save_interval=1000,
            sample_interval=1000, log_interval=1,
            checkpoint_dir=str(tmp_path / "ckpt"), vae_scale=1.0), **train),
        "wandb": {"run_name": "profiled"}})


def test_step_profiler_traces_jax_window_and_keeps_the_state(tmp_path):
    """6 RFTTrainer steps with profile_start 1: the trace holds steps 1 to
    4 (the JAX package's window: started before step start, stopped after
    step start + count), and the trained state equals an unprofiled
    run's bit for bit."""
    assert _jax_window(1, 3, 6) == [("start", 1), ("stop", 4)]
    states = []
    for profile in (False, True):
        extra = dict(profile_dir=str(tmp_path / "trace"),
                     profile_start=1) if profile else {}
        trainer = get_trainer_cls("rft")(_tiny_rft(tmp_path, **extra),
                                         device="cpu")
        step = trainer.train_step

        def annotated(*a, _step=step, _t=trainer, **kw):
            with torch.profiler.record_function(
                    f"owl_step_{_t.total_step_counter}"):
                return _step(*a, **kw)

        trainer.train_step = annotated
        state = trainer.train(max_steps=6)
        states.append({**{f"p.{k}": v.clone() for k, v in
                          state.model.state_dict().items()},
                       **{f"e.{k}": v.clone() for k, v in
                          state.ema.items()}})
    (path,) = glob.glob(str(tmp_path / "trace" / "rank0_*.pt.trace.json"))
    events = json.load(open(path))["traceEvents"]
    traced = sorted({int(e["name"].rsplit("_", 1)[1]) for e in events
                     if e.get("name", "").startswith("owl_step_")})
    assert traced == [1, 2, 3, 4]
    assert set(states[0]) == set(states[1])
    for k, v in states[0].items():
        assert torch.equal(v, states[1][k]), k


# ----------------------------------------------------------- embeddings

@pytest.mark.parametrize("steps", [np.float32(4.0),
                                   np.array([1.0, 2.0, 8.0, 128.0],
                                            np.float32)])
def test_step_embedding_matches_jax(steps):
    jmod, params = jax_init(jemb.StepEmbedding(16, d_in=32,
                                               dtype=jnp.float32), steps)
    want = np.asarray(jax_apply(jmod, params, steps))
    port = emb.StepEmbedding(16, d_in=32, dtype=torch.float32,
                             device="cpu")
    port.load_state_dict(params_from_jax(numpy_params(params), 1),
                         strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(np.asarray(steps))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_condition_embedding_and_learned_pos_enc_match_jax():
    ids = np.array([[0, 3, 4], [2, 2, 1]], np.int32)
    jmod, params = jax_init(jemb.ConditionEmbedding(5, 16,
                                                    dtype=jnp.float32), ids)
    want = np.asarray(jax_apply(jmod, params, ids))
    port = emb.ConditionEmbedding(5, 16, dtype=torch.float32, device="cpu")
    port.load_state_dict(params_from_jax(numpy_params(params), 1),
                         strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    x = np.random.RandomState(0).randn(2, 8, 16).astype(np.float32)
    jmod, params = jax_init(jemb.LearnedPosEnc(8, 16, dtype=jnp.float32), x,
                            rngs=1)
    pos = emb.LearnedPosEnc(8, 16, dtype=torch.float32, device="cpu")
    pos.load_state_dict(params_from_jax(numpy_params(params), 1),
                        strict=True)
    for n in (8, 5):           # a shorter input takes the table's end
        want = np.asarray(jax_apply(jmod, params, x[:, :n]))
        with torch.no_grad():
            got = pos(torch.from_numpy(x[:, :n])).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the modules' own draws: the table 0.02 N(0, 1), the MLPs scaled
    # kaiming, all from the generator
    gen = torch.Generator().manual_seed(0)
    for m in (pos, port, emb.StepEmbedding(16, dtype=torch.float32,
                                           device="cpu")):
        m.reset_parameters(gen)
        assert all(torch.isfinite(p).all() for p in m.parameters())
    assert 0.01 < float(pos.p.detach().std()) < 0.03


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l2_and_gained_rms_norm_match_jax(dtype):
    rs = np.random.RandomState(1)
    x = rs.randn(3, 5, 16).astype(np.float32)
    gain = (0.1 * rs.randn(16)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    for got, want in (
            (norms.l2_norm(torch.from_numpy(x).to(td)),
             jnorms.l2_norm(jnp.asarray(x, jd))),
            (norms.gained_rms_norm(torch.from_numpy(x).to(td),
                                   torch.from_numpy(gain)),
             jnorms.gained_rms_norm(jnp.asarray(x, jd), jnp.asarray(gain)))):
        assert got.dtype == td
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


# -------------------------------------------------------------- helpers

def test_freeze_and_find_unused_params_match_jax():
    rs = np.random.RandomState(2)
    tree = {"a": {"kernel": rs.randn(3, 4).astype(np.float32),
                  "bias": np.zeros(4, np.float32)},
            "b": {"scale": np.full(4, 1e-7, np.float32)}}
    named = params_from_jax(tree, 1)          # a.weight, a.bias, b.weight
    names = {"a/kernel": "a.weight", "a/bias": "a.bias", "b/scale":
             "b.weight"}
    for atol in (0.0, 1e-6):
        want = sorted(names[n] for n in jax_unused(tree, atol=atol))
        assert sorted(find_unused_params(named, atol=atol)) == want
    # frozen tensors pass no gradient, in either package
    x = np.ones(3, np.float32)
    g = jax.grad(lambda p: jnp.sum(x @ jax_freeze(p)["a"]["kernel"]
                                   + p["a"]["bias"]))(tree)
    lin = torch.nn.Linear(3, 4)
    frozen = freeze(lin)
    assert not frozen["weight"].requires_grad
    assert frozen["weight"].data_ptr() == lin.weight.data_ptr()
    (torch.ones(3) @ frozen["weight"].T + lin.bias).sum().backward()
    assert lin.weight.grad is None and not np.any(g["a"]["kernel"])
    assert find_unused_params(lin) == ["weight"]


def test_latest_step_dir_matches_jax(tmp_path):
    """tests/test_logging.py's spec, and the port trainer's step_N.pt."""
    for fn in (jax_latest, latest_step_dir):
        assert fn(str(tmp_path / "nope")) is None
    for s in (10, 2, 30):
        os.makedirs(tmp_path / f"step_{s}")
    os.makedirs(tmp_path / "other")
    assert latest_step_dir(str(tmp_path)) == jax_latest(str(tmp_path))
    assert latest_step_dir(str(tmp_path)).endswith("step_30")
    files = tmp_path / "ckpt"
    files.mkdir()
    for s in (6, 12):
        (files / f"step_{s}.pt").write_bytes(b"")
    (files / "step_x.pt").write_bytes(b"")
    assert latest_step_dir(str(files)).endswith("step_12.pt")


def test_channel_gifs_and_wandb_wrappers_match_jax(tmp_path, monkeypatch):
    """The GIFs byte for byte; the wandb wrappers return the raw array
    where wandb is absent (neither machine has it) and hand wandb the
    same arrays where it is there (a recording stand-in module, as
    another test file may have stubbed wandb in this process)."""
    import sys
    import types
    latents = np.random.RandomState(0).randn(4, 3, 8, 8)
    want = jmedia.channel_gifs(latents, str(tmp_path / "j"), "s",
                               channels=(0, 2))
    got = media.channel_gifs(latents, str(tmp_path / "p"), "s",
                             channels=(0, 2))
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] == ["s_ch0.gif", "s_ch2.gif"]
    for g, w in zip(got, want):
        assert open(g, "rb").read() == open(w, "rb").read()
    video = np.random.RandomState(1).rand(2, 4, 4, 3) * 2 - 1
    wave = np.random.RandomState(2).randn(100, 2) * 0.1
    pairs = ((media.wandb_video, jmedia.wandb_video, video),
             (media.wandb_audio, jmedia.wandb_audio, wave))
    monkeypatch.setitem(sys.modules, "wandb", None)   # import fails
    for port, ref, arg in pairs:
        assert port(arg) is arg and ref(arg) is arg
    fake = types.ModuleType("wandb")
    fake.Video = lambda data, fps: ("video", data, fps)
    fake.Audio = lambda data, sample_rate: ("audio", data, sample_rate)
    monkeypatch.setitem(sys.modules, "wandb", fake)
    for port, ref, arg in pairs:
        (kind, a, rate), (kind_j, a_j, rate_j) = port(arg), ref(arg)
        assert (kind, rate) == (kind_j, rate_j)
        np.testing.assert_array_equal(a, a_j)


def test_detect_peak_tflops_reads_the_card(monkeypatch, tmp_path):
    """The H100 variants' dense bf16 peaks; the SXM card's name gives 989,
    and MFUProfiler reports against it."""
    cases = {"NVIDIA H100 80GB HBM3": 989.0, "NVIDIA H100 PCIe": 756.0,
             "NVIDIA H100 NVL": 835.0, "NVIDIA A100-SXM4-80GB": 989.0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, peak in cases.items():
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda i=0, n=name: n)
        assert mfu.detect_peak_tflops() == peak, name
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 PCIe")
    cfg = _tiny_rft(tmp_path).model
    prof = mfu.MFUProfiler(cfg, batch_tokens=16, seq_len=16)
    prof._steps, prof._elapsed = 1, 1.0
    rep = prof.report()
    assert rep["perf/mfu"] == rep["perf/achieved_tflops"] / 756.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mfu.detect_peak_tflops() == mfu.H100_PEAK_TFLOPS == 989.0


def test_is_quantized_kernel_matches_jax():
    w = np.random.RandomState(3).randn(64, 32).astype(np.float32)
    jtree = jwquant.quantize_params_int8({"l": {"kernel": jnp.asarray(w)}},
                                         min_elems=1)
    for v in (jtree["l"]["kernel"], {"q": 1}, w, {"s": 1, "q": 2}):
        assert wquant.is_quantized_kernel(v) == \
            jwquant.is_quantized_kernel(v)
    lin = Linear(32, 64, dtype=torch.float32, device="cpu")
    lin.weight.data.copy_(torch.from_numpy(w))
    assert not wquant.is_quantized_kernel(lin)
    lin.quantize_()
    assert wquant.is_quantized_kernel(lin)
