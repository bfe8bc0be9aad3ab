"""Shared helpers of the tests/test_torch_port_*.py files, which hold the
PyTorch port (owl_audio_exps_tpu_torch) against the JAX package on the
CPU: inputs are made with numpy from a seed and handed to both."""

from __future__ import annotations

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from owl_audio_exps_tpu.configs import Config as JaxConfig
from owl_audio_exps_tpu.configs import transformer_config as jax_config
from owl_audio_exps_tpu.models.audiorft import AudioRFTCore as JaxAudioCore
from owl_audio_exps_tpu.models.gamerft import GameRFTCore as JaxVideoCore
from owl_audio_exps_tpu.models.gamerft_audio import (
    GameRFTAudioCore as JaxAVCore)
from owl_audio_exps_tpu.trainers import get_trainer_cls as jax_trainer_cls
from owl_audio_exps_tpu_torch.configs import Config
from owl_audio_exps_tpu_torch.configs import transformer_config as port_config
from owl_audio_exps_tpu_torch.models.audiorft import AudioRFTCore
from owl_audio_exps_tpu_torch.models.gamerft import GameRFTCore
from owl_audio_exps_tpu_torch.models.gamerft_audio import GameRFTAudioCore
from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
from owl_audio_exps_tpu_torch.utils.weights import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Each pytest-xdist worker runs torch on its share of the cores: torch's
# default of a thread per core in every worker oversubscribes them, and
# its threads spin while they wait for one another.
_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))

TINY_AV = dict(
    model_id="game_rft_audio", n_layers=2, n_heads=2, d_model=32,
    channels=4, audio_channels=4, sample_size=2, tokens_per_frame=5,
    n_frames=8, n_buttons=11, uncond=False, has_audio=True,
    rope_impl="ortho", local_window=2, global_window=None, cfg_prob=0.0)


def configs(**overrides):
    """(JAX config, port config) with the same keys."""
    kw = dict(TINY_AV, **overrides)
    return jax_config(**kw), port_config(**kw)


def numpy_params(params):
    return jax.tree.map(np.asarray, params)


# ------------------------------------------------------------------------
# The JAX reference, built once a process: a module's variables once for
# each module (its repr holds its config), argument shapes and keys, and
# its jitted ``apply`` once for each module and set of static keywords,
# in place of flax's eager apply, which compiles every primitive. Tests
# build their port modules and both configs afresh: they mutate them.

_MODULES, _INITS, _APPLIES = {}, {}, {}


def _shared(module):
    """The process's first module of ``module``'s type and repr."""
    return _MODULES.setdefault((type(module), repr(module)), module)


def _keys(rngs):
    """An int seed, or {rng name: seed}, as the keys ``init`` takes."""
    if isinstance(rngs, int):
        return jax.random.key(rngs)
    return {name: jax.random.key(seed) for name, seed in rngs.items()}


def jax_init(module, *args, rngs=0):
    """(shared module, ``jax.jit(module.init)(rngs, *args)``); only the
    arguments' shapes and dtypes reach the variables."""
    module = _shared(module)
    key = (id(module), repr(rngs),
           tuple((np.shape(a), str(a.dtype)) for a in args))
    if key not in _INITS:
        _INITS[key] = jax.jit(module.init)(_keys(rngs), *args)
    return module, _INITS[key]


def _static(value) -> bool:
    return value is None or callable(value) or isinstance(
        value, (bool, int, float, str, tuple))


def jax_apply(module, variables, *args, **kw):
    """``module.apply(variables, *args, **kw)`` under ``jax.jit``: keywords
    holding None, a number, a string, a tuple or a callable are static;
    arrays, KV caches and rng dicts are traced."""
    static = tuple(sorted(k for k, v in kw.items() if _static(v)))
    key = (id(_shared(module)), static)
    if key not in _APPLIES:
        _APPLIES[key] = jax.jit(module.apply, static_argnames=static)
    return _APPLIES[key](variables, *args, **kw)


def load_jax_params(module: torch.nn.Module, params, n_heads: int):
    """Load JAX params into a port module; every key must match."""
    module.load_state_dict(params_from_jax(numpy_params(params), n_heads),
                           strict=True)
    return module


def carried(port_cls, pcfg, params):
    """A float32 ``port_cls(pcfg)`` carrying the JAX ``params``."""
    return load_jax_params(port_cls(pcfg, dtype=torch.float32, device="cpu",
                                    seed=None), params, pcfg.n_heads)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@functools.cache
def jax_serve_pipelines():
    """The JAX package's inference/pipeline.py, loaded once from its
    file."""
    spec = importlib.util.spec_from_file_location(
        "jax_serve_pipeline", os.path.join(REPO, "inference", "pipeline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# The cached serve's cores (tests/test_torch_port_{av_caching,av_window,
# cached_serve,eval}.py): 3 layers, local_idx 2, so layers 0 and 2 are
# global and layer 1 local; JAX params from key 0 carried into a float32
# port core.
VIDEO = dict(model_id="game_rft", n_layers=3, n_heads=2, d_model=64,
             channels=4, sample_size=2, tokens_per_frame=4, n_frames=16,
             n_buttons=3, causal=True, uncond=False, has_audio=False,
             rope_impl="ortho", local_window=2, global_window=None,
             cfg_prob=0.0, local_idx=2)
AV = dict(VIDEO, model_id="game_rft_audio", audio_channels=4,
          tokens_per_frame=5, has_audio=True, n_frames=8)


# config keys that steer how a core computes and leave its parameters as
# they are: cores that differ only in them share one init
ROUTING = ("split_local_cache", "cache_attn_impl", "attn_impl",
           "decode_impl", "local_attn_impl", "kv_quant", "rope_headroom")
# a training wrapper's init keys: its params' and its noise draws'
MODEL_RNGS = dict(params=0, noise=1)


def jax_core(jax_cls, jcfg, *args, rngs=0):
    """(shared JAX module, variables): ``jax_cls(jcfg)`` in float32, its
    variables from ``rngs`` on the first row of ``args`` (``jax_init``)."""
    return jax_init(jax_cls(jcfg, dtype=jnp.float32),
                    *(np.asarray(a)[:1] for a in args), rngs=rngs)


def cores(jax_cls, port_cls, base, shapes, **over):
    """(JAX config, port config, shared JAX core, its params, float32 port
    core carrying them) of ``base`` with ``over`` (``jax_core``)."""
    kw = dict(base, **over)
    jcfg, pcfg = jax_config(**kw), port_config(**kw)
    plain = jax_config(**{k: v for k, v in kw.items() if k not in ROUTING})
    _, params = jax_core(jax_cls, plain,
                         *(np.zeros(s, np.float32) for s in shapes))
    return (jcfg, pcfg, _shared(jax_cls(jcfg, dtype=jnp.float32)), params,
            carried(port_cls, pcfg, params))


# the video and AV cores' init shapes: (x, [audio,] ts, mouse, btn)
VIDEO_SHAPES = ((1, 4, 4, 2, 2), (1, 4), (1, 4, 2), (1, 4, 3))
AV_SHAPES = ((1, 4, 4, 2, 2), (1, 4, 4), (1, 4), (1, 4, 2), (1, 4, 3))


def video_cores(**over):
    return cores(JaxVideoCore, GameRFTCore, VIDEO, VIDEO_SHAPES, **over)


def av_cores(**over):
    return cores(JaxAVCore, GameRFTAudioCore, AV, AV_SHAPES, **over)


# The audio model's core (tests/test_torch_port_audio.py): 4
# layers, layers 0 and 2 global, 1 and 3 local.
AUDIO = dict(model_id="audio_rft", n_layers=4, n_heads=2, d_model=32,
             channels=8, tokens_per_frame=1, n_frames=64, sample_size=16,
             causal=True, uncond=True, has_audio=True, rope_impl="audio1d",
             local_window=4, global_window=None, cfg_prob=0.0,
             backbone="dit", local_idx=2)


def audio_cores(**over):
    return cores(JaxAudioCore, AudioRFTCore, AUDIO, ((1, 8, 8), (1, 8)),
                 **over)


def video_inputs(seed, b, n_ctx, n_ctrl):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, n_ctx, 4, 2, 2).astype(np.float32),
            rs.randn(b, n_ctrl, 2).astype(np.float32),
            (rs.rand(b, n_ctrl, 3) > 0.5).astype(np.float32))


# the ring KV cache's state (nn/kv_cache.py): counters, rings, int8 scales
COUNTERS = ("start", "length", "rope_offset", "lstart", "llength")
RINGS = ("k", "v", "lk", "lv", "ks", "vs", "lks", "lvs")


def assert_same_state(jc, pc, atol: float = 1e-6):
    """The ring state of a JAX cache and a port cache: counters exact,
    rings within ``atol``."""
    for name in COUNTERS:
        a, b = getattr(jc, name), getattr(pc, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert b.dtype == torch.int32 and b.ndim == 0, name
            assert int(a) == int(b), name
    for name in RINGS:
        a, b = getattr(jc, name), getattr(pc, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert tuple(a.shape) == tuple(b.shape), name
            np.testing.assert_allclose(b.float().numpy(),
                                       np.asarray(a, np.float32),
                                       atol=atol, rtol=0, err_msg=name)
    assert (jc.shadow, jc.lshadow, jc.groups, jc.slots) == \
        (pc.shadow, pc.lshadow, pc.groups, pc.slots)


def jax_sampler_draws(key, ctx_shape, item, num: int):
    """The float32 draws of a JAX cached sampler (sampling/
    audio_caching.py, sampling/av_caching.py) as numpy arrays (ctx, init,
    renoise): split(key) -> (rng, r_ctx), the context's draw of
    ``ctx_shape``, then per step split(rng, 3) -> (rng, r_init,
    r_renoise), each [b, 1, *item]."""
    f32 = jax.numpy.float32
    rng, r_ctx = jax.random.split(key)
    ctx = np.asarray(jax.random.normal(r_ctx, tuple(ctx_shape), f32))
    shape = (ctx_shape[0], 1) + tuple(item)
    init, renoise = [], []
    for _ in range(num):
        rng, r_init, r_ren = jax.random.split(rng, 3)
        init.append(np.asarray(jax.random.normal(r_init, shape, f32)))
        renoise.append(np.asarray(jax.random.normal(r_ren, shape, f32)))
    return ctx, np.stack(init), np.stack(renoise)


# ------------------------------------------------------------------------
# The band kernels' walk (owl_audio_exps_tpu_torch/csrc/hopper_attention.cuh
# kv_range, q_range and tile_full, run causal with a frame window and no
# documents; band and band2 alike), written again in Python so the CPU
# tests can hold it to the dense mask. A model of the kernels' arithmetic,
# not a measurement of them.

BLOCK_ROWS, HALF_ROWS = 128, 64   # a block's own tile; one consumer's half
# each kernel: the height of the other operand's tiles it walks
WALKS = {"fwd": 128, "dq": 64, "dkv": 64}
SKIP, FULL, PARTIAL = 0, 1, 2


def tile_class(r0: int, r1: int, c0: int, c1: int, n_tokens: int,
               tokens_per_frame: int, window: int) -> int:
    """Exact class of query rows [r0, r1) against key rows [c0, c1), global
    token indices, under the causal frame window. Rows and keys at or
    past L are invisible."""
    re, ce = min(r1, n_tokens), min(c1, n_tokens)
    if re <= r0 or ce <= c0:
        return SKIP
    tpf = tokens_per_frame
    lo = r0 // tpf - (ce - 1) // tpf
    hi = (re - 1) // tpf - c0 // tpf
    if hi < 0 or lo > window - 1:
        return SKIP
    if lo >= 0 and hi <= window - 1 and r1 <= n_tokens and c1 <= n_tokens:
        return FULL
    return PARTIAL


def kv_range(n_tokens: int, tokens_per_frame: int, window: int, q0: int,
             rows: int, bk: int):
    """Key rows [begin, end) that can be visible from query rows [q0, q0 +
    rows), begin aligned down to ``bk`` (the kernel's kv_range)."""
    tpf = tokens_per_frame
    fq_lo, fq_hi = q0 // tpf, (min(q0 + rows, n_tokens) - 1) // tpf
    fk_min = max(0, fq_lo - window + 1)
    return fk_min * tpf // bk * bk, min((fq_hi + 1) * tpf, n_tokens)


def q_range(n_tokens: int, tokens_per_frame: int, window: int, k0: int,
            rows: int, bq: int):
    """Query rows [begin, end) that can see some key of rows [k0, k0 +
    rows): query frames fk .. fk + window - 1, begin aligned down to
    ``bq`` (the kernel's q_range, causal)."""
    tpf, nf = tokens_per_frame, -(-n_tokens // tokens_per_frame)
    fk_lo, fk_hi = k0 // tpf, (min(k0 + rows, n_tokens) - 1) // tpf
    fq_max = min(nf - 1, fk_hi + window - 1)
    return fk_lo * tpf // bq * bq, min((fq_max + 1) * tpf, n_tokens)


def tile_full(n_tokens: int, tokens_per_frame: int, window: int, q0: int,
              nq: int, k0: int, nk: int) -> bool:
    """The kernel's FULL test of query rows [q0, q0 + nq) against key rows
    [k0, k0 + nk) (tile_full, causal, a window, no documents)."""
    if q0 + nq > n_tokens or k0 + nk > n_tokens:
        return False
    tpf = tokens_per_frame
    fq_lo, fq_hi = q0 // tpf, (q0 + nq - 1) // tpf
    fk_lo, fk_hi = k0 // tpf, (k0 + nk - 1) // tpf
    return (fk_hi <= fq_lo and fq_hi - fk_lo < window
            and fk_hi - fq_lo < window)


def block_tiles(n_tokens: int, tokens_per_frame: int, window: int,
                kind: str):
    """(own row, other row) of every tile the blocks of kernel ``kind``
    ("fwd", "dq" or "dkv") visit: a block owns BLOCK_ROWS rows (queries,
    or keys for dkv) and walks the other operand's range in tiles of
    ``WALKS[kind]`` rows, ceil((end - begin) / height) of them."""
    other = WALKS[kind]
    rng = q_range if kind == "dkv" else kv_range
    for t0 in range(0, n_tokens, BLOCK_ROWS):
        begin, end = rng(n_tokens, tokens_per_frame, window, t0, BLOCK_ROWS,
                         other)
        for o0 in range(begin, end, other):
            yield t0, o0


def band_walk(n_tokens: int, tokens_per_frame: int, window: int,
              kind: str):
    """((query rows), (key rows), class) of every (consumer half, tile)
    pair kernel ``kind`` visits, as the kernel classes it: FULL (no mask)
    or PARTIAL (masked per element)."""
    other = WALKS[kind]
    for t0, o0 in block_tiles(n_tokens, tokens_per_frame, window, kind):
        for h0 in (t0, t0 + HALF_ROWS):
            (q0, nq), (k0, nk) = (((o0, other), (h0, HALF_ROWS))
                                  if kind == "dkv" else
                                  ((h0, HALF_ROWS), (o0, other)))
            full = tile_full(n_tokens, tokens_per_frame, window, q0, nq, k0,
                             nk)
            yield (q0, q0 + nq), (k0, k0 + nk), FULL if full else PARTIAL


def av_inputs(rs: np.random.RandomState, b: int, n: int, cfg, dtype=np.float32):
    """(x, audio, t, mouse, btn) numpy inputs of the AV core."""
    p = cfg.sample_size
    return (rs.randn(b, n, cfg.channels, p, p).astype(dtype),
            rs.randn(b, n, cfg.audio_channels).astype(dtype),
            rs.rand(b, n).astype(dtype),
            rs.randn(b, n, 2).astype(dtype),
            (rs.rand(b, n, cfg.n_buttons) > 0.5).astype(dtype))


# ------------------------------------------------------------------------
# The distillation trainers (tests/test_torch_port_distill*.py) at
# tests/test_distill.py's tiny width, and their tolerances: losses rtol
# 1e-5; gradients atol 1e-5, rtol 1e-3; states after a step atol 1e-6.

LOSS_RTOL, GRAD_ATOL, GRAD_RTOL, STATE_ATOL = 1e-5, 1e-5, 1e-3, 1e-6

MODEL = dict(model_id="game_rft", n_layers=2, n_heads=2, d_model=32,
             channels=4, sample_size=2, tokens_per_frame=4, n_frames=8,
             n_buttons=3, causal=True, uncond=False, has_audio=False,
             rope_impl="ortho", local_window=2, global_window=None,
             cfg_prob=0.0)
KW = dict(window_length=4, channels=4, sample_size=2, n_buttons=3)


def raw_cfg(tmp_path, trainer_id, model=None, **train):
    return {
        "model": dict(MODEL, **(model or {})),
        "train": dict(dict(
            trainer_id=trainer_id, data_id="synthetic_latent",
            data_kwargs=dict(KW), target_batch_size=2, batch_size=2,
            epochs=1, opt="AdamW", opt_kwargs={"lr": 1e-3},
            d_opt_kwargs={"lr": 2e-3}, checkpoint_dir=str(tmp_path / "ckpt"),
            save_interval=1000, sample_interval=1000, vae_scale=0.63,
            update_ratio=2, rollout_steps=2, min_rollout_frames=2,
            regression_weight=0.1), **train),
        "wandb": {"run_name": f"test_{trainer_id}"}}


def jax_example_args(cfg):
    return (jnp.zeros((1, 4, 4, 2, 2)), jnp.zeros((1, 4)),
            jnp.zeros((1, 4, 2)), jnp.zeros((1, 4, cfg.n_buttons)))


_DISTILL = {}


def _jax_trainer(raw):
    """(JAX trainer, its state) of ``raw``, made once a process for each
    config apart from its checkpoint directory; each caller gets its own
    copy of the state, which the trainer's steps donate."""
    key = repr(dict(raw, train=dict(raw["train"], checkpoint_dir=None)))
    if key not in _DISTILL:
        jtr = jax_trainer_cls(raw["train"]["trainer_id"])(
            JaxConfig.from_dict(raw))
        jtr.student = jtr.critic = JaxVideoCore(jtr.model_cfg,
                                                dtype=jnp.float32)
        jtr.teacher = JaxVideoCore(jtr.teacher_cfg, dtype=jnp.float32)
        jstate = jtr.init_distill_state(jtr.example_args())
        _, critic = jax_init(jtr.critic, *jax_example_args(jtr.model_cfg),
                             rngs=2)
        _DISTILL[key] = jtr, jstate.replace(critic_params=critic["params"])
    jtr, jstate = _DISTILL[key]
    return jtr, jax.tree.map(
        lambda a: jnp.copy(a) if isinstance(a, jax.Array) else a, jstate)


def trainers(tmp_path, trainer_id, model=None, **train):
    """(JAX trainer, its state, port trainer, its state) on the same
    float32 weights; the critic starts from weights of its own."""
    raw = raw_cfg(tmp_path, trainer_id, model, **train)
    jtr, jstate = _jax_trainer(raw)

    ptr = get_trainer_cls(trainer_id)(Config.from_dict(raw), device="cpu",
                                      dtype=torch.float32)
    pstate = ptr.init_distill_state()
    for core, params in ((pstate.student, jstate.student_params),
                         (pstate.critic, jstate.critic_params),
                         (ptr.teacher, jtr.teacher_params)):
        load_jax_params(core, params, 2)
    pstate.student_ema = ptr.ema_of(pstate.student)
    return jtr, jstate, ptr, pstate


def batch(seed, b=2, n=4):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, n, 4, 2, 2).astype(np.float32),
            rs.randn(b, n, 2).astype(np.float32),
            (rs.rand(b, n, 3) > 0.5).astype(np.float32))


def assert_grads(named_params, jax_grads, n_heads=2):
    want = params_from_jax(numpy_params(jax_grads), n_heads)
    got = {n: p.grad for n, p in named_params}
    assert set(got) == set(want)
    for name, g in got.items():
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)


def assert_params(named, jax_tree, n_heads=2, what=""):
    want = params_from_jax(numpy_params(jax_tree), n_heads)
    got = dict(named)
    assert set(got) == set(want)
    for name, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=STATE_ATOL, rtol=0,
                                   err_msg=f"{what}{name}")


def _tree_of(named):
    """{dotted name: array} -> the nested tree the names spell (the JAX
    package's watch groups a tree by its first path components, as the
    port groups names)."""
    tree = {}
    for name, a in named.items():
        node = tree
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(a)
    return tree


def assert_watch(got, want):
    """A sharded rank's ``train.watch`` dict against another's: the same
    keys, norms and histogram ranges rtol 1e-5 (float32 sums in another
    order), histogram counts exact."""
    assert set(got) == set(want)
    for key, w in want.items():
        if key.startswith("watch_hist/") and not key.endswith(("_lo",
                                                               "_hi")):
            np.testing.assert_array_equal(got[key], w, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], w, rtol=1e-5, err_msg=key)


def jax_watch_of(params, grads, bins):
    """The JAX package's ``watch_metrics`` ('full') of the port's named
    parameters and gradients ({name: array}), as numpy."""
    from owl_audio_exps_tpu.utils.telemetry import watch_metrics
    out = watch_metrics(_tree_of(params), _tree_of(grads), "full",
                        bins=bins)
    return {k: np.asarray(v) for k, v in out.items()}
