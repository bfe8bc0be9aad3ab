"""The port's context parallelism (parallel/{dist,mesh,context}.py, K4's
plain version in ops/splash.py, ops/local.py) against the JAX package, on
the CPU.

Multi-rank runs are spawned gloo processes (tests/torch_sp_workers.py,
which imports no JAX), joined through a ``file://`` rendezvous in the
test's tmp_path. Inputs are numpy from a seed, handed to both sides.
Tolerances: K4's plain version and the ring and halo against the JAX
package and the full-sequence oracle are held to the JAX package's own
(tests/test_context_parallel.py: forward 3e-5, gradients 3e-4, float32
reassociation); the chunked local attention to 2e-5 as in
tests/test_local_attention.py; the context-parallel model to 3e-5 of the
JAX model without it; one trainer step at seq 4 (model in float32) to
the seq-1 step with loss rtol 1e-5 and gradients atol 1e-4 (float32 sums
in another order through 4 layers, the ring merging partials where the
seq-1 step runs one softmax).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from owl_audio_exps_tpu.configs import transformer_config as jax_config
from owl_audio_exps_tpu.models.gamerft import GameRFT as JaxGameRFT
from owl_audio_exps_tpu.models.gamerft import GameRFTCore as JaxCore
from owl_audio_exps_tpu.ops import local as jax_local
from owl_audio_exps_tpu.ops import splash as jax_splash
from owl_audio_exps_tpu.ops.attention import dot_attention as jax_dot
from owl_audio_exps_tpu.ops.masks import dense_mask as jax_mask
from owl_audio_exps_tpu.parallel.context import shard_attention
from owl_audio_exps_tpu.utils.layer_stacking import convert_params
from owl_audio_exps_tpu_torch.configs import Config
from owl_audio_exps_tpu_torch.configs import transformer_config as port_config
from owl_audio_exps_tpu_torch.models.gamerft import GameRFTCore
from owl_audio_exps_tpu_torch.nn.attn import (attention_forwards_per_step,
                                              local_layer_flags)
from owl_audio_exps_tpu_torch.ops import local, splash
from owl_audio_exps_tpu_torch.parallel import mesh as pmesh
from owl_audio_exps_tpu_torch.train import port_cuts
from owl_audio_exps_tpu_torch.utils.weights import params_from_jax

import torch_sp_workers as workers
from torch_port_util import MODEL_RNGS, jax_apply, jax_core, numpy_params, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, DH, TPF = 1, 2, 8, 4


# ------------------------------------------------------------------ K4

@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_k4_plain_matches_jax_splash_lse(causal):
    rs = np.random.RandomState(0 if causal else 1)
    L = 128
    q, k, v, g_out = (rs.randn(B, H, L, DH).astype(np.float32)
                      for _ in range(4))
    g_lse = rs.randn(B, H, L).astype(np.float32)
    q *= DH ** -0.5          # the ring hands in pre-scaled q
    jo, jl = jax_splash.splash_attention_lse(
        *(jnp.asarray(a) for a in (q, k, v)), TPF, causal, interpret=True)
    po, pl = splash.splash_attention_lse(t(q), t(k), t(v), TPF, causal)
    assert po.dtype == pl.dtype == torch.float32
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=3e-5,
                               rtol=3e-5)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=3e-5,
                               rtol=3e-5)

    want = jax_splash.splash_attention_lse_vjp(
        *(jnp.asarray(a) for a in (q, k, v)), jo, jl, jnp.asarray(g_out),
        jnp.asarray(g_lse), TPF, causal, interpret=True)
    got = splash.splash_attention_lse_vjp(t(q), t(k), t(v), po, pl,
                                          t(g_out), t(g_lse), TPF, causal)
    # autograd of the CPU path through both outputs gives the same
    leaves = [t(a).requires_grad_() for a in (q, k, v)]
    o, lse = splash.splash_attention_lse(*leaves, TPF, causal)
    auto = torch.autograd.grad((o, lse), leaves, (t(g_out), t(g_lse)))
    for name, a, b, c in zip("qkv", got, want, auto):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-4,
                                   rtol=3e-4, err_msg=f"d{name}")
        torch.testing.assert_close(c, a, atol=1e-6, rtol=1e-6)


# ----------------------------------------------------------- chunked local

@pytest.mark.parametrize("halo", ["none", "valid", "invalid", "docs"])
def test_chunked_local_matches_jax(halo):
    rs = np.random.RandomState(2)
    tpf, window, n_frames = 4, 2, 12
    L, C = n_frames * tpf, 2 * 4
    q, k, v = (rs.randn(2, 3, L, DH).astype(np.float32) for _ in range(3))
    kh, vh = (rs.randn(2, 3, C, DH).astype(np.float32) for _ in range(2))
    kw, jkw = {}, {}
    if halo in ("valid", "invalid"):
        kw = dict(halo_kv=(t(kh), t(vh)), halo_valid=halo == "valid")
        jkw = dict(halo_kv=(jnp.asarray(kh), jnp.asarray(vh)),
                   halo_valid=jnp.asarray(halo == "valid"))
    if halo == "docs":
        docs = np.array([[0] * 5 + [1] * 4 + [2] * 3, [0] * 12], np.int32)
        kw, jkw = dict(doc_id=t(docs)), dict(doc_id=jnp.asarray(docs))
    want = jax_local.chunked_local_attention(
        *(jnp.asarray(a) for a in (q, k, v)), tpf, window, **jkw)
    got = local.chunked_local_attention(t(q), t(k), t(v), tpf, window,
                                        **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    if halo in ("none", "invalid", "docs"):   # the dense oracle too
        mask = jax_mask(L, tpf, window, jkw.get("doc_id"), 0, True)
        oracle = jax_dot(*(jnp.asarray(a) for a in (q, k, v)), mask)
        np.testing.assert_allclose(got.numpy(), np.asarray(oracle),
                                   atol=2e-5, rtol=2e-5)
    assert local.chunked_local_available(L, tpf, window, True) == \
        jax_local.chunked_local_available(L, tpf, window, True)
    for args in ((L, tpf, window, False), (L, tpf, None, True),
                 (C, tpf, window, True), (L + 4, tpf, window, True)):
        assert not local.chunked_local_available(*args)


# ------------------------------------------------------------ ring + halo

def _jax_full(q, k, v, gw, window, n):
    """JAX shard_attention on an n-device CPU mesh and the dense oracle:
    (out, grads) of each under the loss vdot(out, gw)."""
    mesh = JaxMesh(np.asarray(jax.devices()[:n]), ("seq",))
    L = q.shape[2]
    sp = lambda q, k, v: shard_attention(mesh, "seq")(q, k, v, TPF, window)
    full = lambda q, k, v: jax_dot(q, k, v,
                                   jax_mask(L, TPF, window, None, 0, True))
    args = [jnp.asarray(a) for a in (q, k, v)]
    res = []
    for fn in (sp, full):
        out = jax.jit(fn)(*args)
        grads = jax.jit(jax.grad(lambda *a: jnp.vdot(fn(*a), gw),
                                 argnums=(0, 1, 2)))(*args)
        res.append((np.asarray(out), [np.asarray(g) for g in grads]))
    return res


# the model of tests/test_context_parallel.py
SP_MODEL = dict(
    model_id="game_rft", sample_size=2, channels=4, n_layers=2, n_heads=2,
    d_model=32, tokens_per_frame=4, n_buttons=3, cfg_prob=0.0, n_frames=16,
    causal=True, uncond=False, backbone="dit", has_audio=False,
    rope_impl="ortho", local_window=2, global_window=None)


@functools.cache
def _sp_model_ref():
    """The inputs of the JAX model without SP, its draws, its state dict
    in the port's names, its core's prediction on the noised inputs and
    its loss."""
    rs = np.random.RandomState(11)
    x = rs.randn(2, 16, 4, 2, 2).astype(np.float32)
    mouse = rs.randn(2, 16, 2).astype(np.float32)
    btn = (rs.rand(2, 16, 3) > 0.5).astype(np.float32)
    model, params = jax_core(JaxGameRFT, jax_config(**SP_MODEL), x, mouse,
                             btn, rngs=MODEL_RNGS)
    out = jax_apply(model, params, x, mouse, btn, return_dict=True,
                    rngs={"noise": jax.random.key(2)})
    draws = [np.asarray(out[key]) for key in ("ts", "z_video", "cfg_mask")]
    te = draws[0][:, :, None, None, None]
    lerpd = x * (1 - te) + draws[1] * te
    want_pred, _ = jax_apply(
        JaxCore(jax_config(**SP_MODEL), dtype=jnp.float32),
        {"params": params["params"]["core"]}, lerpd, draws[0], mouse, btn,
        has_controls=draws[2])
    sd = params_from_jax(numpy_params(params), SP_MODEL["n_heads"])
    return ((x, mouse, btn), draws, sd, np.asarray(want_pred),
            float(out["diffusion_loss"]))


@pytest.fixture(scope="module")
def seq_worlds(tmp_path_factory):
    """n -> ((q, k, v, gw), per-rank results) of one gloo world of n ranks:
    the halo and the ring on the same inputs (two window chunks a shard
    either way), and at 4 ranks also the context-parallel model and one
    trainer step (``_sp_config``)."""
    runs = {}

    def run(n):
        if n not in runs:
            tmp = tmp_path_factory.mktemp(f"seq{n}")
            rs = np.random.RandomState(n)
            L = n * 2 * 2 * TPF
            arrays = tuple(rs.randn(B, H, L, DH).astype(np.float32)
                           for _ in range(4))
            jobs = [(str(w), "ring_halo_worker", arrays + (TPF, w))
                    for w in (2, None)]
            if n == 4:
                inputs, draws, sd, _, _ = _sp_model_ref()
                jobs += [("model", "model_worker", (
                    dict(SP_MODEL, sequence_parallel=True), sd, inputs,
                    draws)), ("trainer", "trainer_step_worker", (
                        _sp_config(tmp / "sp", 4)[0].to_dict(),))]
            runs[n] = arrays, workers.run_ranks(workers.run_jobs, n,
                                                tmp / "ranks", jobs)
        return runs[n]
    return run


@pytest.mark.parametrize("window", [2, None], ids=["halo", "ring"])
@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_ring_and_halo_match_jax_and_the_full_sequence(n_shards, window,
                                                       seq_worlds):
    (q, k, v, gw), res = seq_worlds(n_shards)
    res = [r[str(window)] for r in res]
    out = np.concatenate([r["out"] for r in res], axis=2)
    grads = [np.concatenate([r["grads"][i] for r in res], axis=2)
             for i in range(3)]
    for want_out, want_grads in _jax_full(q, k, v, jnp.asarray(gw), window,
                                          n_shards):
        np.testing.assert_allclose(out, want_out, atol=3e-5, rtol=3e-5)
        for name, a, b in zip("qkv", grads, want_grads):
            np.testing.assert_allclose(a, b, atol=3e-4, rtol=3e-4,
                                       err_msg=f"d{name}")
    # ring: n partials in the forward, n - 1 more from the per-step
    # checkpoint's recompute; the halo runs none
    n_fwd = n_shards if window is None else 0
    assert all(r["partials_forward"] == n_fwd for r in res)
    assert all(r["partials_total"] == (2 * n_fwd - 1 if n_fwd else 0)
               for r in res)
    assert all(r["forbidden"] == [] for r in res)   # the ranks ran no JAX


def test_sp_model_matches_jax_without_sp(seq_worlds):
    _, _, _, want_pred, want_loss = _sp_model_ref()
    res = [r["model"] for r in seq_worlds(4)[1]]
    pred = np.concatenate([r["pred"] for r in res], axis=1)
    np.testing.assert_allclose(pred, want_pred, atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(sum(r["loss"] for r in res), want_loss,
                               atol=3e-5, rtol=3e-5)


# -------------------------------------------------------------- trainer

def _sp_config(tmp_path, world: int):
    """configs/dit_v4_98k_sp.yml with the port's cuts for ``world``
    processes, then cut to CPU size: 4 layers x d 32 (2 heads), 2 x 2
    latents (tpf 4), 16 frames, a 2-frame window, batch 2 in 2 micro
    batches."""
    cfg = Config.from_yaml(os.path.join(REPO, "configs",
                                        "dit_v4_98k_sp.yml"))
    cuts = port_cuts(cfg, world)
    m, t = cfg.model, cfg.train
    assert m.sequence_parallel and m.scan_layers and \
        m.remat_granularity == "group" and t.opt == "Muon"
    for key, value in dict(n_layers=4, d_model=32, n_heads=2, channels=4,
                           sample_size=2, tokens_per_frame=4, n_frames=16,
                           local_window=2).items():
        m[key] = value
    t.data_kwargs = dict(window_length=16, channels=4, sample_size=2,
                         n_buttons=m.n_buttons)
    t.target_batch_size, t.batch_size = 2, 1
    t.checkpoint_dir = str(tmp_path / "ckpt")
    t.output_path = None
    t.log_interval = 1
    return cfg, cuts


def test_sp_trainer_step_matches_seq1(tmp_path, seq_worlds):
    cfg4, cuts = _sp_config(tmp_path, 4)
    assert [c.split()[0] for c in cuts] == ["data_id", "mesh"]
    assert cfg4.train.mesh["seq"] == 4 and cfg4.train.data_id == \
        "synthetic_latent"
    res = [r["trainer"] for r in seq_worlds(4)[1]]
    assert [r["mesh"] for r in res] == [(1, 4)] * 4
    assert all(r["step"] == 1 and r["accum"] == 2 for r in res)
    # ring partials per rank: per micro batch and global layer, each of
    # the layer's attention forwards under group remat (3 for a group's
    # first layer) runs n partials, and its backward recomputes n - 1
    cfg4_model = cfg4.model
    fwd = attention_forwards_per_step(cfg4_model)
    flags = local_layer_flags(cfg4_model)
    per_micro = sum(f * 4 + 3 for f, local in zip(fwd, flags) if not local)
    assert per_micro == 15
    assert all(r["ring_partials"] == 2 * per_micro for r in res)
    assert len(res[0]["losses"]) == 1 and not any(r["losses"]
                                                  for r in res[1:])

    cfg1, _ = _sp_config(tmp_path, 1)   # one process: seq 1, no SP
    ref = workers.trainer_step_worker(cfg1.to_dict())
    np.testing.assert_allclose(res[0]["losses"][0], ref["losses"][0],
                               rtol=1e-5)
    assert set(ref["grads"]) == set(res[0]["grads"])
    for name, g in ref["grads"].items():
        for r in res:   # every rank takes the same step
            np.testing.assert_allclose(r["grads"][name], g, atol=1e-4,
                                       rtol=0, err_msg=name)


def test_mesh_config_and_the_port_cuts():
    assert pmesh.get_mesh().seq == 1 and pmesh.make_mesh().data == 1
    # fsdp runs; on one process it wants more processes than it has
    with pytest.raises(ValueError, match="processes"):
        pmesh.make_mesh(pmesh.MeshConfig(fsdp=2))
    # pipe runs too; on one process it wants more processes than it has
    with pytest.raises(ValueError, match="processes"):
        pmesh.make_mesh(pmesh.MeshConfig(pipe=2))
    with pytest.raises(ValueError, match="processes"):
        pmesh.make_mesh(pmesh.MeshConfig(seq=2))
    with pytest.raises(ValueError, match="unknown"):
        pmesh.MeshConfig.from_dict({"sequence": 2})
    assert pmesh.MeshConfig.from_dict({"data": 1, "seq": 8}).seq == 8
    assert pmesh.Mesh(seq=4, seq_index=2).seq_frames(16) == (8, 12)
    with pytest.raises(ValueError, match="split"):
        pmesh.Mesh(seq=3).seq_frames(16)
    cfg = Config.from_yaml(os.path.join(REPO, "configs",
                                        "dit_v4_98k_sp.yml"))
    cuts = port_cuts(cfg, 4)
    # the rft eval runs the cached video sampler: av_caching is kept
    assert len(cuts) == 2 and cfg.train.sampler_id == "av_caching"
    assert cfg.train.data_kwargs["window_length"] == 1536
    assert dict(cfg.train.mesh.items())["seq"] == 4
    assert port_cuts(cfg, 4) == []      # nothing left to cut


# ---------------------------------------------------------- scan_layers

@pytest.mark.parametrize("local_idx", [4, 2])
def test_params_from_jax_takes_the_scanned_layout(local_idx):
    """The period of the scanned layout comes from the tree: a group holds
    local_idx blocks (4 in dit_v4, 2 in configs/dit_v4_prune.yml)."""
    base = dict(model_id="game_rft", n_layers=8, n_heads=2, d_model=32,
                channels=4, sample_size=2, tokens_per_frame=4, n_frames=8,
                n_buttons=3, causal=True, uncond=False, rope_impl="motion",
                local_window=2, global_window=None, cfg_prob=0.0,
                local_idx=local_idx)
    rs = np.random.RandomState(5)
    x = rs.randn(2, 4, 4, 2, 2).astype(np.float32)
    ts = rs.rand(2, 4).astype(np.float32)
    mouse = rs.randn(2, 4, 2).astype(np.float32)
    btn = (rs.rand(2, 4, 3) > 0.5).astype(np.float32)
    args = (x, ts, mouse, btn)
    _, params = jax_core(JaxCore, jax_config(**base), *args)
    stacked = convert_params(params["params"], to_scanned=True, n_layers=8,
                             local_idx=local_idx)
    assert "groups" in stacked["transformer"]
    want, _ = jax_apply(JaxCore(jax_config(**base, scan_layers=True),
                                dtype=jnp.float32), {"params": stacked},
                        *args)

    sd = params_from_jax(numpy_params(stacked), base["n_heads"])
    flat = params_from_jax(numpy_params(params["params"]),
                           base["n_heads"])
    assert set(sd) == set(flat)
    for key in flat:
        torch.testing.assert_close(sd[key], flat[key], atol=0, rtol=0)
    port = GameRFTCore(port_config(**base, scan_layers=True),
                       dtype=torch.float32, device="cpu", seed=None)
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(*(t(a) for a in (x, ts, mouse, btn)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


# ------------------------------------------------- chip_smoke's one process

def test_chip_smoke_ring_and_halo_in_one_process_on_the_cpu():
    """chip_smoke.py's context phase runs the ring and the halo of all
    slices in one process through the per-step functions; on the CPU
    (plain partials, chunked halo) that equals the full sequence, forward
    and gradients, and the ring runs n partials a slice in the forward
    and n - 1 more in the backward."""
    import chip_smoke
    n, window = 4, 2
    L = n * 2 * window * TPF
    rs = np.random.RandomState(12)
    q, k, v, g = (t(rs.randn(B, H, L, DH).astype(np.float32))
                  for _ in range(4))
    with workers.count_ring_partials() as calls:
        ring = chip_smoke.grads_of(lambda *t: chip_smoke.ring_one_process(
            *t, TPF, n), q, k, v, g)
    assert calls[0] == n * n + n * (n - 1)
    halo = chip_smoke.grads_of(lambda *t: chip_smoke.halo_one_process(
        *t, TPF, window, n, None), q, k, v, g)
    for got, (w, fn) in ((ring, (None, splash.splash_attention_plain)),
                         (halo, (window, splash.splash_attention_plain))):
        want = chip_smoke.grads_of(lambda *t: fn(*t, TPF, w, True),
                                   q, k, v, g)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=3e-5, rtol=3e-5)


def test_torchrun_entry_point_trains_context_parallel_on_gloo(tmp_path):
    """The four-card command, on the CPU: torchrun starts 2 processes of
    owl_audio_exps_tpu_torch.train on configs/dit_v4_98k_sp.yml (cut to
    CPU size as in _sp_config, data_id and mesh left for the entry
    point's own cuts), which join over gloo and take two steps; rank 0
    alone logs and saves."""
    import subprocess
    import sys
    import yaml
    cfg = Config.from_yaml(os.path.join(REPO, "configs",
                                        "dit_v4_98k_sp.yml"))
    for key, value in dict(n_layers=4, d_model=32, n_heads=2, channels=4,
                           sample_size=2, tokens_per_frame=4, n_frames=16,
                           local_window=2).items():
        cfg.model[key] = value
    t = cfg.train
    t.data_kwargs = dict(window_length=16)
    t.target_batch_size, t.save_interval, t.log_interval = 1, 2, 1
    t.checkpoint_dir = str(tmp_path / "ckpt")
    t.output_path = None
    path = tmp_path / "sp.yml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "owl_audio_exps_tpu_torch.train",
         "--config_path", str(path), "--device", "cpu", "--max_steps", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout
    # data_id and mesh; the rft eval's av_caching sampler is kept
    assert out.count("[train] cut:") == 2 and "mesh seq 8 -> 2" in out
    assert out.count("[step 1]") == 1 and out.count("[step 2]") == 1
    assert (tmp_path / "ckpt" / "step_2.pt").exists()


def test_sp_smoke_runs_context_parallel_on_gloo(tmp_path):
    """sp_smoke.py, the multi-card run of the training entry point, on the
    CPU: 2 gloo processes take two steps of configs/dit_v4_98k_sp.yml cut
    to CPU size, every rank ends with the same parameters, and rank 0
    prints the JSON line last."""
    import json
    import subprocess
    import sys
    import yaml
    cfg = Config.from_yaml(os.path.join(REPO, "configs",
                                        "dit_v4_98k_sp.yml"))
    for key, value in dict(n_layers=4, d_model=32, n_heads=2, channels=4,
                           sample_size=2, tokens_per_frame=4, n_frames=16,
                           local_window=2).items():
        cfg.model[key] = value
    cfg.train.data_kwargs = dict(window_length=16)
    cfg.train.target_batch_size = 2
    path = tmp_path / "sp.yml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "sp_smoke.py", "--config_path", str(path),
         "--device", "cpu", "--max_steps", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert "same parameters on every rank: True" in lines[-2]
    out = json.loads(lines[-1])
    assert out["ok"] and out["world"] == 2
    assert [r["seq_index"] for r in out["reports"]] == [0, 1]
    assert all(len(r["losses"]) == 2 and r["failures"] == []
               for r in out["reports"])


def test_chip_smoke_shard_round_trip_and_block_split_on_the_cpu():
    """chip_smoke.py's phase 16 at tiny width on the CPU: (a) the
    parameter tree split for every rank of {fsdp 4}, {tensor 4} and
    {fsdp 2, tensor 2} and put together bit for bit; (b) a global and a
    local block split 4 ways over tensor, each rank's slice run in turn in
    one process with the row-parallel partials summed, equal to the whole
    block in float32 (forward and every gradient, 1e-5 relative) with
    two documents (the plain attention, which counts no launch)."""
    import chip_smoke
    cfg = port_config(model_id="game_rft", n_layers=2, n_heads=4,
                      d_model=64, channels=4, sample_size=2,
                      tokens_per_frame=TPF, n_frames=16, n_buttons=3,
                      causal=True, uncond=False, rope_impl="motion",
                      local_window=2, global_window=None, cfg_prob=0.0,
                      attn_impl="splash")
    core = GameRFTCore(cfg, dtype=torch.float32, device="cpu", seed=0)
    rows = chip_smoke.shard_round_trip(core, tag="cpu")
    assert set(rows) == {"fsdp4", "tensor4", "fsdp2_tensor2"}
    assert all(r["bit_equal"] and r["params_per_rank"] < r["params"]
               for r in rows.values())
    gen = torch.Generator().manual_seed(3)
    n = 8
    x = torch.randn(1, n * TPF, 64, generator=gen)
    cond = torch.randn(1, n, 64, generator=gen)
    doc = (torch.arange(n) >= 3).int()[None]
    for block in core.transformer.blocks:
        errs, counts = chip_smoke.split_block_errors(block, 4, x, cond, doc,
                                                     gen)
        assert len(errs) > 10 and max(errs.values()) < 1e-5, errs
        assert not any(counts.values())


def test_mesh_smoke_runs_fsdp_and_tensor_on_gloo(tmp_path):
    """mesh_smoke.py, the 4-card run of the sharded trainer and serve, on
    4 gloo processes at configs/dit_v4_5B.yml cut to CPU size: {fsdp 4}
    and {fsdp 2, tensor 2} each take a step from the script's packed
    table, the 2-layer copy (with train.watch: full) matches one
    process, and the head-sharded serve at {tensor 4} matches the whole
    model; rank 0 prints the JSON line last. The test runs AdamW (eps 1e-4, ROADMAP Queue 3's watch
    item on Adam's first step): at this width one Muon step moves the
    weights by a large fraction, and its bf16 NS5 lifts the tensor ranks'
    bf16 partial-sum rounding past the 3e-2 parameter limit; the card
    runs the config's Muon at full width."""
    import json
    import subprocess
    import sys
    import yaml
    cfg = Config.from_yaml(os.path.join(REPO, "configs", "dit_v4_5B.yml"))
    for key, value in dict(n_layers=4, d_model=64, n_heads=4, channels=4,
                           sample_size=2, tokens_per_frame=4, n_frames=16,
                           local_window=2).items():
        cfg.model[key] = value
    cfg.train.data_kwargs["window_length"] = 16
    cfg.train.opt = "AdamW"
    cfg.train.opt_kwargs = {"lr": 1e-4, "eps": 1e-4}
    path = tmp_path / "5b.yml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "4", "mesh_smoke.py", "--config_path",
         str(path), "--device", "cpu", "--max_steps", "1",
         "--serve_ticks", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, (res.stdout[-3000:], res.stderr[-3000:])
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["ok"] and out["world"] == 4
    assert set(out["train"]) == {"fsdp 4", "fsdp 2 x tensor 2"}
    heads = [[r["heads"] for r in out["train"][m]["reports"]]
             for m in ("fsdp 4", "fsdp 2 x tensor 2")]
    assert heads == [[4] * 4, [2] * 4]
    assert all(p["param_rel_l2"] < 3e-2 for p in out["parity"].values())
    # the copies' train.watch: full against one process's
    assert all(p["watch_keys"] > 0 and p["watch_norm_rel"] < 0.1
               and not p["failures"] for p in out["parity"].values())
    assert out["serve"]["ring_heads_per_rank"] == 1
    assert not out["serve"]["graphed"]


# ------------------------------------------------------------- slice 14

def test_chip_smoke_pipe_av_split_and_distill_triple_on_the_cpu():
    """chip_smoke.py's phase 17 at tiny width in one process, float32:
    (a) an 8-layer DiT (4 groups) split into 2 and 4 stages with 2
    micro-batches handed over in memory equals the whole stack (out and
    every gradient within 1e-5 relative); (b) the AV layer at tpf 65 split
    4 ways through the ring and halo step functions equals the unsplit
    layer (1e-5); (d) the distillation triple split for {fsdp 2, tensor
    2} and put together again bit for bit."""
    import chip_smoke
    cfg = port_config(model_id="game_rft", n_layers=8, n_heads=2,
                      d_model=32, channels=4, sample_size=2,
                      tokens_per_frame=TPF, n_frames=16, n_buttons=3,
                      causal=True, uncond=False, rope_impl="motion",
                      local_window=2, global_window=None, cfg_prob=0.0,
                      local_idx=2)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 16 * TPF, 32, generator=gen)
    cond = torch.randn(2, 16, 32, generator=gen)
    limits = (chip_smoke.SPLIT_OUT_REL, chip_smoke.SPLIT_GRAD_REL)
    try:
        chip_smoke.SPLIT_OUT_REL = chip_smoke.SPLIT_GRAD_REL = 1e-5
        pipe = chip_smoke.pipe_one_process_phase("cpu", cfg, x, cond,
                                                 dtype=torch.float32)
        av = chip_smoke.av_split_phase("cpu", L=4 * 2 * 2 * 65, n=4,
                                       tpf=65, window=2, H=2, Dh=8,
                                       dtype=torch.float32)
    finally:
        chip_smoke.SPLIT_OUT_REL, chip_smoke.SPLIT_GRAD_REL = limits
    assert set(pipe) == {"K2", "K4"}
    assert all(r["worst_grad_rel_l2"] < 1e-5 and r["out_rel_l2"] < 1e-5
               for r in pipe.values())
    assert set(pipe["K4"]["launches_per_stage_and_micro_batch"]) == {
        f"{s}/{m}" for s in range(4) for m in range(2)}
    assert max(max(e.values()) for e in av["rel_l2"].values()) < 1e-5
    rows = chip_smoke.distill_triple_phase("cpu", cfg, cfg)
    assert set(rows) == {"student", "critic", "teacher"}
    assert all(r["bit_equal"] and r["params_per_rank"] < r["params"]
               for row in rows.values() for r in row.values())


def _tiny_yaml(tmp_path, name, model, train=None):
    import yaml
    cfg = Config.from_yaml(os.path.join(REPO, "configs", name))
    for key, value in model.items():
        cfg.model[key] = value
    for key, value in (train or {}).items():
        cfg.train[key] = value
    path = tmp_path / name
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    return path


def _torchrun(n, *argv):
    import subprocess
    import sys
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(n), *map(str, argv)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, OMP_NUM_THREADS="1"))


TINY_5B = dict(n_layers=12, d_model=64, n_heads=4, channels=4,
               sample_size=2, tokens_per_frame=4, n_frames=16,
               local_window=2)


def test_mesh_smoke_runs_the_pipe_case_on_gloo(tmp_path):
    """mesh_smoke.py --case pipe on 3 gloo processes at
    configs/dit_v4_5B.yml cut to CPU size (12 layers, 3 groups: one a
    stage): the pipelined steps from the windowed loader, each rank its
    stage's blocks, the whole checkpoint collected on stage 0, the
    12-layer copy (with train.watch: full) against one process (AdamW
    with eps 1e-4, as test_mesh_smoke_runs_fsdp_and_tensor_on_gloo says
    why)."""
    import json
    path = _tiny_yaml(tmp_path, "dit_v4_5B.yml", TINY_5B, dict(
        data_kwargs={"window_length": 16}, opt="AdamW",
        opt_kwargs={"lr": 1e-4, "eps": 1e-4}))
    res = _torchrun(3, "mesh_smoke.py", "--case", "pipe", "--config_path",
                    path, "--device", "cpu", "--max_steps", "2")
    assert res.returncode == 0, (res.stdout[-3000:], res.stderr[-3000:])
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["ok"] and out["world"] == 3 and out["case"] == "pipe"
    stages = [r["train"]["stage"] for r in out["runs"]]
    blocks = [r["train"]["blocks"] for r in out["runs"]]
    assert stages == [0, 1, 2] and blocks == [[0, 3], [4, 7], [8, 11]]
    assert len({tuple(r["train"]["losses"]) for r in out["runs"]}) == 1
    # the whole checkpoint collected on stage 0 and serialized there
    ckpt = [r["train"]["checkpoint"] for r in out["runs"]]
    assert ckpt[0]["gib"] > 0 and ckpt[0]["tensors"] > 0
    assert all("gib" not in c for c in ckpt[1:])
    (parity,) = out["parity"].values()
    assert parity["loss_rel"] < 1e-2 and parity["param_rel_l2"] < 3e-2
    assert parity["grad_rel_l2"] < 0.1 and parity["update_rel_l2"] < 0.25
    assert not parity["failures"] and not parity["grads_skipped"]
    # the copy's train.watch: full against one process's, every step
    assert parity["watch_keys"] > 0 and parity["watch_norm_rel"] < 0.1
    assert "[pipe] cut: data_id 'sequence_packing' -> 'cod'" in res.stdout


def test_mesh_smoke_runs_the_distill_case_on_gloo(tmp_path):
    """mesh_smoke.py --case distill on 4 gloo processes: CausVid at {data
    4} and {fsdp 2, tensor 2}, Self-Forcing and ODE at {data 4}, on the
    three configs cut to CPU size (their teacher too), the {fsdp 2,
    tensor 2} CausVid run against one process."""
    import json
    tiny = dict(n_layers=2, d_model=64, n_heads=4, channels=4,
                sample_size=2, tokens_per_frame=4, n_frames=16,
                local_window=2)
    teacher = _tiny_yaml(tmp_path, "dit_v4.yml", tiny)
    paths = []
    for name, extra in (("dit_v4_dmd.yml", {}),
                        ("dit_v4_sf.yml", dict(min_rollout_frames=2)),
                        ("dit_v4_prune.yml", dict(ode_steps=2))):
        paths.append(_tiny_yaml(tmp_path, name, tiny, dict(
            data_kwargs={"window_length": 4}, teacher_cfg=str(teacher),
            update_ratio=2, **extra)))
    res = _torchrun(4, "mesh_smoke.py", "--case", "distill",
                    "--distill_configs", ",".join(map(str, paths)),
                    "--device", "cpu")
    assert res.returncode == 0, (res.stdout[-3000:], res.stderr[-3000:])
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["ok"] and out["world"] == 4 and out["case"] == "distill"
    assert set(out["runs"][0]) == {
        "dit_v4_dmd.yml data 4", "dit_v4_dmd.yml fsdp 2 x tensor 2",
        "dit_v4_sf.yml data 4", "dit_v4_prune.yml data 4"}
    assert [r["dit_v4_dmd.yml fsdp 2 x tensor 2"]["batch_rank"]
            for r in out["runs"]] == [0, 0, 1, 1]
    (parity,) = out["parity"].values()
    assert parity["loss_rel"] < 1e-2 and parity["param_rel_l2"] < 3e-2
    assert parity["grad_rel_l2"] < 0.1 and parity["update_rel_l2"] < 0.25
    assert not parity["failures"]
    assert parity["worst_grad"].split(".")[0] in ("critic", "student")


def test_sp_smoke_runs_the_av_model_on_gloo(tmp_path):
    """sp_smoke.py on configs/av_v5_8x8_weak.yml cut to CPU size (4
    layers, tpf 5) over 4 gloo processes: sequence_parallel and the seq
    axis cut in, 16 frames, group remat, every rank ends with the same
    parameters, and the 4-layer copy at 8 frames matches one process
    (AdamW with eps 1e-4: at this width one Muon step's bf16 NS5 lifts the
    ring's reassociation past the parameter limit, ROADMAP Queue 3's
    watch item; the card runs the config's Muon)."""
    import json
    path = _tiny_yaml(tmp_path, "av_v5_8x8_weak.yml", dict(
        n_layers=4, d_model=64, n_heads=4, channels=4, audio_channels=4,
        sample_size=2, tokens_per_frame=5, local_window=2), dict(
        opt="AdamW", opt_kwargs={"lr": 1e-4, "eps": 1e-4}))
    res = _torchrun(4, "sp_smoke.py", "--config_path", path, "--device",
                    "cpu", "--frames", "16", "--remat", "group",
                    "--check_layers", "4", "--check_frames", "8")
    assert res.returncode == 0, (res.stdout[-3000:], res.stderr[-3000:])
    lines = res.stdout.strip().splitlines()
    assert "same parameters on every rank: True" in lines[-2]
    out = json.loads(lines[-1])
    assert out["ok"] and out["world"] == 4
    assert [r["seq_index"] for r in out["reports"]] == [0, 1, 2, 3]
    assert "sequence_parallel None -> True" in res.stdout
    assert out["parity"]["loss_rel"] < 1e-2
    assert out["parity"]["param_rel_l2"] < 3e-2
    assert out["parity"]["grad_rel_l2"] < 0.1
    assert out["parity"]["update_rel_l2"] < 0.25
    assert not out["parity"]["failures"]


@pytest.mark.parametrize("fault", ["sound", "stage_times_3", "stage_zero",
                                   "one_leaf_half", "update_lost"])
def test_parity_verdict_holds_gradients_and_updates(fault):
    """chip_smoke.py ``parity_verdict``, the gate of the multi-card
    copies: rounding-level differences pass; one stage's gradients scaled
    by 3 or zeroed, one parameter's gradient half summed, or a third of
    the update lost fail, though the losses and the whole model's
    parameters stay within their limits in every case."""
    import chip_smoke
    g = torch.Generator().manual_seed(0)
    names = [f"blocks.{i}.w" for i in range(6)] + ["t_embed.w"]
    init = {n: torch.randn(64, 64, generator=g) for n in names}
    ref_g = {n: torch.randn(64, 64, generator=g) for n in names}
    noise = {n: 1e-3 * torch.randn(64, 64, generator=g) for n in names}
    got_g = {n: ref_g[n] * (1 + noise[n]) for n in names}
    stage1 = names[2:4]
    if fault == "stage_times_3":
        got_g.update({n: 3 * got_g[n] for n in stage1})
    elif fault == "stage_zero":
        got_g.update({n: torch.zeros_like(got_g[n]) for n in stage1})
    elif fault == "one_leaf_half":
        got_g["t_embed.w"] = got_g["t_embed.w"] / 2
    ref = {n: init[n] - 1e-3 * ref_g[n].sign() for n in names}
    got = {n: init[n] - 1e-3 * got_g[n].sign() for n in names}
    if fault == "update_lost":
        got.update({n: init[n].clone() for n in names[:2] + stage1})
    res = chip_smoke.parity_verdict(1e-6, got, ref, init, got_g, ref_g)
    assert res["param_rel_l2"] < 3e-2 and res["loss_rel"] < 1e-2
    assert res["grads_held"] == len(names) and not res["grads_skipped"]
    if fault == "sound":
        assert not res["failures"], res
        assert res["grad_rel_l2"] < 1e-2 and res["update_rel_l2"] < 1e-2
    else:
        assert res["failures"], res
