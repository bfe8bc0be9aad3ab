"""The port's pipe axis (parallel/{mesh,dist,pipeline,sharding}.py, the
pipelined branch of nn/attn.py ``DiT``, the trainer's state by stage)
against the JAX package, on the CPU.

The spec is tests/test_pipeline_parallel.py on its tiny ``audio_rft``
core (8 layers, local_idx 2: 4 groups, ``scan_layers``): the pipelined
forward against JAX's plain scan at {pipe 2, M 2}, {data 2, pipe 2, M 2},
{pipe 4, M 4} and {pipe 4, M 1} within JAX's own 2e-5; the gradients of
mean(out ** 2) at {data 2, pipe 2} within its 5e-5; the composition
with tensor and fsdp, whose JAX cases ({data 2, tensor 2, pipe 2},
{fsdp 2, tensor 2, pipe 2}, {data 2, fsdp 2, pipe 2}) are cut to the
4 ranks of the gloo harness as {tensor 2, pipe 2} and {fsdp 2, pipe 2};
the refusals as in JAX; and a trainer step at {data 2, pipe 2} against
the port's one-process step (loss rtol 1e-5, gradients atol 1e-5), whose
checkpoint, written whole by rank 0 (each stage sends it its tensors),
restores on one process and on every stage bit for bit; a rank builds
its stage's blocks only, seeded as one process seeds them. The ranks are spawned gloo processes (tests/torch_sp_workers.py):
one 4-rank and one 2-rank world for every case.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_audio_exps_tpu.configs import transformer_config as jax_config
from owl_audio_exps_tpu.models.audiorft import AudioRFTCore as JaxCore
from owl_audio_exps_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from owl_audio_exps_tpu.parallel.mesh import make_mesh as jax_make_mesh
from owl_audio_exps_tpu_torch.configs import Config
from owl_audio_exps_tpu_torch.configs import transformer_config as port_config
from owl_audio_exps_tpu_torch.models.audiorft import AudioRFT, AudioRFTCore
from owl_audio_exps_tpu_torch.parallel import mesh as pmesh
from owl_audio_exps_tpu_torch.parallel import pipeline, sharding
from owl_audio_exps_tpu_torch.utils.weights import params_from_jax

import torch_sp_workers as workers
from torch_port_util import assert_watch, jax_core, jax_watch_of, numpy_params

# tests/test_pipeline_parallel.py's _cfg
CFG = dict(model_id="audio_rft", n_layers=8, n_heads=2, d_model=32,
           channels=8, tokens_per_frame=1, n_frames=16, sample_size=16,
           causal=True, uncond=True, has_audio=True, rope_impl="audio1d",
           local_window=4, global_window=None, cfg_prob=0.0, backbone="dit",
           local_idx=2, scan_layers=True)
H = CFG["n_heads"]


def _pipe_kw(micro):
    return dict(CFG, pipeline_parallel=True, pipeline_microbatches=micro)


def _port_tree(tree):
    return {k: v.numpy() for k, v in
            params_from_jax(numpy_params(tree), H).items()}


@pytest.fixture(scope="module")
def ref():
    """JAX's scan on the tiny core: params, inputs, output and the
    gradients of mean(out ** 2), the last two in the port's names."""
    rs = np.random.RandomState(0)
    x = rs.randn(4, 12, 8).astype(np.float32)
    t = rs.rand(4, 12).astype(np.float32)
    core, params = jax_core(JaxCore, jax_config(**CFG), x, t)
    params = params["params"]

    def out(p):
        return core.apply({"params": p}, jnp.asarray(x), jnp.asarray(t))[0]

    grads = jax.jit(jax.grad(
        lambda p: jnp.mean(out(p).astype(jnp.float32) ** 2)))(params)
    return dict(params=params, sd=_port_tree(params), x=x, t=t,
                out=np.asarray(jax.jit(out)(params)),
                grads=_port_tree(grads))


# (name, mesh, micro-batches, with gradients)
WORLD4 = [("data2_pipe2", {"pipe": 2}, 2, True),
          ("pipe4_m4", {"pipe": 4}, 4, False),
          ("pipe4_m1", {"pipe": 4}, 1, False),
          ("tensor2_pipe2", {"tensor": 2, "pipe": 2}, 2, True),
          ("fsdp2_pipe2", {"fsdp": 2, "pipe": 2}, 2, True)]


STEP_MODEL = dict(CFG, n_layers=4, n_frames=8, sample_size=8,
                  pipeline_parallel=True, pipeline_microbatches=2)


def _train_cfg(tmp, mesh):
    """JAX's test_trainer_step_on_data_pipe_mesh config, cut to 4 ranks
    ({data 2, pipe 2}; batch 2 a data rank) and the ranks' float32 model,
    with ``train.watch: full``."""
    return Config.from_dict({
        "model": STEP_MODEL,
        "train": {
            "trainer_id": "audio_rft", "data_id": "synthetic_audio_latent",
            "data_kwargs": {"window_length": 8, "channels": 8},
            "target_batch_size": 4, "batch_size": 2, "epochs": 1,
            "opt": "AdamW", "opt_kwargs": {"lr": 1e-3, "eps": 1e-4},
            "mesh": mesh, "checkpoint_dir": str(tmp / "ckpt"),
            "save_interval": 100, "sample_interval": 1000,
            "vae_scale": 1.0, "watch": "full", "watch_bins": 16},
        "wandb": {"run_name": "pipe_step"}}).to_dict()


def _step_inputs():
    model = AudioRFT(port_config(**STEP_MODEL), dtype=torch.float32,
                     device="cpu", seed=0)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    rs = np.random.RandomState(5)
    batch = rs.randn(4, 8, 8).astype(np.float32)
    draws = (rs.rand(4, 8).astype(np.float32),
             rs.randn(4, 8, 8).astype(np.float32))
    return sd, batch, draws


@pytest.fixture(scope="module")
def world4(ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe4")
    jobs = [(name, "pipe_core", (_pipe_kw(m), ref["sd"], ref["x"],
                                 ref["t"], mesh, grad))
            for name, mesh, m, grad in WORLD4]
    sd, batch, draws = _step_inputs()
    jobs.append(("step", "pipe_train_step", (
        _train_cfg(tmp, {"pipe": 2}), sd, batch, draws,
        str(tmp / "ckpt"))))
    jobs.append(("seeded", "pipe_seeded_state", (
        _train_cfg(tmp / "seeded", {"pipe": 2}),)))
    jobs.append(("restore", "pipe_restore", (
        _train_cfg(tmp, {"pipe": 2}), str(tmp / "ckpt" / "step_1.pt"))))
    res = workers.run_ranks(workers.run_jobs, 4, tmp / "ranks", jobs)
    return dict(res=res, step_inputs=(sd, batch, draws), tmp=tmp)


@pytest.fixture(scope="module")
def world2(ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe2")
    jobs = [("pipe2_m2", "pipe_core", (_pipe_kw(2), ref["sd"], ref["x"],
                                       ref["t"], {"pipe": 2}, False)),
            ("refusals", "pipe_refusals", (_pipe_kw(2), ref["sd"], ref["x"],
                                           ref["t"])),
            ("cached", "pipe_cached_sample", (VIDEO_PIPE,) + _video_ctx())]
    return workers.run_ranks(workers.run_jobs, 2, tmp / "ranks", jobs)


def _assemble(res, name):
    """The whole batch's output from every rank's rows (every pipe rank
    holds the same rows)."""
    out = {}
    for r in res:
        got = r[name]
        out.setdefault(got["rows"], []).append(got["out"])
    for rows, outs in out.items():
        for o in outs[1:]:     # the pipe ranks agree exactly
            np.testing.assert_array_equal(o, outs[0])
    return np.concatenate([outs[0] for _, outs in sorted(out.items())])


@pytest.mark.parametrize("case", ["pipe2_m2", "data2_pipe2", "pipe4_m4",
                                  "pipe4_m1"])
def test_pipelined_forward_matches_jax_scan(case, ref, world2, world4):
    res = world2 if case == "pipe2_m2" else world4["res"]
    np.testing.assert_allclose(_assemble(res, case), ref["out"], atol=2e-5,
                               rtol=2e-5)
    # a rank holds its stage's blocks and every shared parameter
    K = 2 if "pipe2" in case else 4
    for r in res:
        got = r[case]
        blocks = {int(n.split(".")[2]) for n in got["held"]
                  if n.startswith("transformer.blocks.")}
        per = CFG["n_layers"] // K
        s = got["pipe_index"]
        assert blocks == set(range(s * per, (s + 1) * per))
        assert all(stage == (s if n.startswith("transformer.blocks.")
                             else None)
                   for n, (_, stage) in got["held"].items())


@pytest.mark.parametrize("case", ["data2_pipe2", "tensor2_pipe2",
                                  "fsdp2_pipe2"])
def test_pipelined_gradients_match_jax(case, ref, world4):
    """Every parameter's gradient, on every rank that holds it: the
    stages' blocks on their stage, the shared parameters (the timestep
    embedding, which feeds every stage; proj_in, which feeds stage 0;
    proj_out, replicated after the broadcast) whole on every rank."""
    res = world4["res"]
    np.testing.assert_allclose(_assemble(res, case), ref["out"], atol=2e-5,
                               rtol=2e-5)
    seen = set()
    for r in res:
        got = r[case]
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g, ref["grads"][name], atol=5e-5,
                                       rtol=5e-5, err_msg=name)
            seen.add(name)
    assert seen == set(ref["grads"])
    if case != "data2_pipe2":   # the rules sharded something
        full = {n: v.shape for n, v in ref["sd"].items()}
        assert any(shape != full[n] for r in res
                   for n, (shape, _) in r[case]["held"].items())
    # gather_params puts every stage's slices together, on every rank
    for r in res:
        got = r[case]["gathered"]
        assert set(got) == set(ref["sd"])
        for name, want in ref["sd"].items():
            np.testing.assert_array_equal(got[name], want, err_msg=name)


def test_pipe_refusals_match_jax(ref, world2):
    """As in JAX: seq x pipe, document packing, a group count the stages
    do not divide (9 groups over 2), and a batch that the micro-batches
    do not divide."""
    with pytest.raises(ValueError, match="cannot compose with seq=2"):
        pmesh.make_mesh(pmesh.MeshConfig(seq=2, pipe=2))
    from owl_audio_exps_tpu.parallel.pipeline import pipeline_apply
    try:
        mesh = jax_make_mesh(JaxMeshConfig(data=2, seq=2, pipe=2),
                             devices=jax.devices()[:8])
        with pytest.raises(AssertionError, match="seq"):
            pipeline_apply(mesh, {"w": jnp.zeros((2, 4, 4))},
                           jnp.zeros((4, 8, 4)), jnp.zeros((4, 8, 4)), None,
                           None, lambda gp, h, c, lm, gm: h, 2)
        mesh = jax_make_mesh(JaxMeshConfig(pipe=2),
                             devices=jax.devices()[:2])
        with pytest.raises(AssertionError, match="must divide over pipe=2"):
            pipeline_apply(mesh, {"w": jnp.zeros((9, 4, 4))},
                           jnp.zeros((4, 8, 4)), jnp.zeros((4, 8, 4)), None,
                           None, lambda gp, h, c, lm, gm: h, 2)
        with pytest.raises(AssertionError, match="microbatches"):
            pipeline_apply(mesh, {"w": jnp.zeros((2, 4, 4))},
                           jnp.zeros((4, 8, 4)), jnp.zeros((4, 8, 4)), None,
                           None, lambda gp, h, c, lm, gm: h, 3)
        core = JaxCore(jax_config(**_pipe_kw(2)), dtype=jnp.float32)
        with pytest.raises(AssertionError, match="document packing"):
            core.apply({"params": ref["params"]}, jnp.asarray(ref["x"]),
                       jnp.asarray(ref["t"]),
                       doc_id=jnp.zeros(ref["t"].shape, jnp.int32))
    finally:
        jax_make_mesh(JaxMeshConfig())
    # the port: 9 groups over 2 stages
    core = AudioRFTCore(port_config(**dict(_pipe_kw(2), n_layers=18)),
                        dtype=torch.float32, device="cpu", seed=0)
    with pytest.raises(ValueError, match="n_groups=9 must divide over "
                                         "pipe=2 stages"):
        sharding.split_stages(core, pmesh.Mesh(pipe=2, pipe_index=1,
                                               pipe_ranks=[0, 1]))
    refused = world2[0]["refusals"]
    assert "into M=3 microbatches" in refused["batch"]
    assert refused["docs"] == \
        "pipeline_parallel + document packing unsupported"
    # without the JAX package's conditions every rank runs the whole stack
    m = pmesh.Mesh(pipe=2)
    assert pipeline.pipeline_active(port_config(**_pipe_kw(2)), m)
    for off in (dict(scan_layers=False), dict(pipeline_parallel=False),
                dict(n_layers=7)):
        assert not pipeline.pipeline_active(
            port_config(**dict(_pipe_kw(2), **off)), m)


# a pipelined scan_layers video core (tests/test_torch_port_sharding.py's
# tiny DiT, 4 layers in 2 groups) and its eval sample's inputs
VIDEO_PIPE = dict(model_id="game_rft", n_layers=4, n_heads=2, d_model=32,
                  channels=4, sample_size=2, tokens_per_frame=4, n_frames=8,
                  n_buttons=3, causal=True, uncond=False, has_audio=False,
                  rope_impl="ortho", local_window=4, global_window=None,
                  cfg_prob=0.0, backbone="dit", local_idx=2,
                  scan_layers=True, pipeline_parallel=True,
                  pipeline_microbatches=1)


def _video_ctx():
    rs = np.random.RandomState(4)
    return (rs.randn(1, 4, 4, 2, 2).astype(np.float32),
            rs.randn(1, 6, 2).astype(np.float32),
            (rs.rand(1, 6, 3) > 0.5).astype(np.float32))


def test_cached_forward_at_a_pipe_mesh_is_refused_in_both_packages(world2):
    """The rft trainer's eval sample (``av_caching``) on a pipelined
    scan_layers core at {pipe 2}: JAX's cached forward runs unrolled
    blocks, which the scanned parameters (``groups``) do not hold, and
    raises (its uncached forward pipelines:
    test_pipelined_forward_matches_jax_scan); a port rank holds only its
    stage's blocks and raises too (ROADMAP.md Queue 3, reference
    behaviour 15)."""
    from flax.errors import ScopeParamNotFoundError
    from owl_audio_exps_tpu.models.gamerft import GameRFTCore as JaxVideo
    from owl_audio_exps_tpu.sampling import get_sampler_cls as jax_sampler
    x, mouse, btn = (jnp.asarray(a) for a in _video_ctx())
    core = JaxVideo(jax_config(**VIDEO_PIPE), dtype=jnp.float32)
    sampler = jax_sampler("av_caching")(n_steps=2, num_frames=2,
                                        cfg_scale=1.0)
    try:
        jax_make_mesh(JaxMeshConfig(pipe=2), devices=jax.devices()[:2])
        params = jax.jit(core.init)(jax.random.key(0), x,
                                    jnp.zeros(x.shape[:2]), mouse[:, :4],
                                    btn[:, :4])
        assert set(params["params"]["transformer"]) == {"groups"}
        with pytest.raises(ScopeParamNotFoundError, match="blocks_0"):
            sampler(core, params, x, mouse, btn, jax.random.key(1))
    finally:
        jax_make_mesh(JaxMeshConfig())
    for r in world2:
        assert "split over pipeline stages" in r["cached"]


@pytest.fixture(scope="module")
def pipe_one(world4):
    """The port's one-process trainer step on the whole batch."""
    sd, batch, draws = world4["step_inputs"]
    tmp = world4["tmp"]
    return workers.pipe_train_step(_train_cfg(tmp / "one", {}), sd, batch,
                                   draws, str(tmp / "one" / "ckpt"))


def test_pipe_watch_matches_one_process_and_jax(world4, pipe_one):
    """``train.watch: full`` at {data 2, pipe 2}: every rank's dict is the
    same (a stage adds the other stage's blocks), equals the one-process
    step's (norms rtol 1e-5, histogram counts exact) and the JAX
    package's ``watch_metrics`` of the same parameters and gradients."""
    sd = world4["step_inputs"][0]
    grads = {}
    for r in world4["res"]:
        assert_watch(r["step"]["watch"], pipe_one["watch"])
        for k, v in world4["res"][0]["step"]["watch"].items():
            np.testing.assert_array_equal(r["step"]["watch"][k], v)
        grads.update(r["step"]["grads"])
    assert set(grads) == set(sd)
    assert_watch(world4["res"][0]["step"]["watch"],
                 jax_watch_of(sd, grads, 16))


def test_pipe_trainer_step_matches_one_process(world4, pipe_one):
    """A trainer step at {data 2, pipe 2} (blocks held only by their
    stage) against the port's one-process step on the whole batch."""
    one = pipe_one
    for r in world4["res"]:
        got = r["step"]
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], one["grad_norm"],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["param_norm"], one["param_norm"],
                                   rtol=1e-5)
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g, one["grads"][name], atol=1e-5,
                                       rtol=0, err_msg=name)
        s = got["pipe_index"]
        for name, stage in got["stages"].items():
            if ".blocks." in name:
                assert stage == s and int(name.split(".")[3]) // 2 == s
        assert not any(f"blocks.{i}." in n for n in got["stages"]
                       for i in range(4) if i // 2 != s)
        # the logical state is the whole model's on the first rank of
        # each pipe group, the other stage's ranks send theirs there
        if s:
            assert got["logical"] is None
            continue
        for key in ("params", "ema"):
            assert set(got["logical"][key]) == set(one["logical"][key])
        # in one process's order, which numbers the moments
        assert got["logical"]["order"] == one["logical"]["order"]


def test_pipe_rank_allocates_its_stage_and_seeds_it_as_one_process(world4):
    """Under {data 2, pipe 2} a model built from the seed allocates only
    its stage's blocks (the others stay on the meta device), and the
    trainer's seeded state holds the one-process model's weights bit for
    bit."""
    sd = _step_inputs()[0]
    for r in world4["res"]:
        got, s = r["seeded"], r["seeded"]["pipe_index"]
        assert got["meta"] == [i for i in range(4) if i // 2 != s]
        assert not any(f"blocks.{i}." in n for n in got["params"]
                       for i in got["meta"])
        assert len(got["params"]) < len(sd)
        for name, v in got["params"].items():
            np.testing.assert_array_equal(v, sd[name], err_msg=name)


def test_pipe_checkpoint_restores_on_one_process_bit_equal(world4):
    """Rank 0 wrote the whole state of the {data 2, pipe 2} run; one
    process restores it bit for bit (parameters, EMA, moments numbered as
    one process numbers them), and so does the {data 2, pipe 2} mesh,
    each stage taking its own blocks."""
    from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
    tmp = world4["tmp"]
    want = world4["res"][0]["step"]["logical"]
    path = os.path.join(tmp / "ckpt", "step_1.pt")
    cfg = Config.from_dict(_train_cfg(tmp / "restore", {}))
    trainer = get_trainer_cls("audio_rft")(cfg, device="cpu")
    state = trainer.load(path, trainer.init_state())
    full = trainer.logical_state(state)
    for key, got in (("params", full["params"]),
                     ("ema", full["ema_params"])):
        assert set(got) == set(want[key])
        for name, v in got.items():
            np.testing.assert_array_equal(v.float().numpy(),
                                          want[key][name], err_msg=name)
    moments = workers._opt_arrays(full["opt_state"])
    assert set(moments) == set(want["moments"]) and moments
    for k, v in moments.items():
        np.testing.assert_array_equal(v, want["moments"][k], err_msg=str(k))
    assert list(full["ema_params"]) == want["order"]
    for r in world4["res"]:
        got = r["restore"]
        # every rank restores its own stage bit for bit
        for key in ("params", "ema"):
            for name, v in got["own"][key].items():
                np.testing.assert_array_equal(v, want[key][name],
                                              err_msg=name)
        assert len(got["held"]) < len(want["params"])
        if r["step"]["pipe_index"]:
            assert "params" not in got
            continue
        # the first rank of each pipe group gathers the whole state back
        for key in ("params", "ema"):
            for name, v in got[key].items():
                np.testing.assert_array_equal(v, want[key][name],
                                              err_msg=name)
        for k, v in got["moments"].items():
            np.testing.assert_array_equal(v, want["moments"][k],
                                          err_msg=str(k))
        assert set(got["moments"]) == set(want["moments"])


@pytest.mark.parametrize("sizes", [dict(pipe=2), dict(pipe=4, fsdp=2),
                                   dict(pipe=2, tensor=2)])
def test_pipe_rule_matches_jax_spec_for_path(sizes):
    """JAX's pipe rule over the scan-stacked tree (a group leaf shards its
    leading dim over pipe where it divides, the rules shift to the
    per-group dims), on every leaf of the tiny scanned core at 4 and 3
    groups."""
    import types
    from owl_audio_exps_tpu.parallel import sharding as jax_sharding
    full = dict(dict(data=1, fsdp=1, tensor=1, seq=1, pipe=1), **sizes)
    for n_layers in (8, 6):
        core = JaxCore(jax_config(**dict(CFG, n_layers=n_layers)),
                       dtype=jnp.float32)
        tree = jax.eval_shape(core.init, jax.random.key(0),
                              jax.ShapeDtypeStruct((1, 4, 8), jnp.float32),
                              jax.ShapeDtypeStruct((1, 4), jnp.float32))
        n_piped = 0
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            name = "/".join(str(getattr(k, "key", k)) for k in path[1:])
            want = tuple(jax_sharding.spec_for_path(
                name, leaf.shape, types.SimpleNamespace(shape=full)))
            got = sharding.spec_for_path(name, leaf.shape, full)
            assert got == want, (name, got, want)
            n_piped += bool(got) and got[0] == "pipe"
        groups = n_layers // CFG["local_idx"]
        assert (n_piped > 0) == (groups % sizes["pipe"] == 0)
