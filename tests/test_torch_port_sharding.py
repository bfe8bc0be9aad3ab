"""The port's fsdp and tensor mesh axes (parallel/{mesh,dist,sharding}.py,
the sharded trainer and Muon, the checkpoints, the head-sharded ring)
against the JAX package, on the CPU.

The rule table is compared exactly: for every parameter of three models
(the tiny DiT of tests/test_multichip_serve.py, its ``n_heads: 3`` guard
case, and configs/dit_v4_5B.yml's shapes, JAX's from ``jax.eval_shape``,
the port's on the meta device) the port's axis of each torch dim and
each rank's rows equal JAX ``spec_for_path``'s, the fused QKV's rows by
head. The multi-rank runs are spawned gloo processes
(tests/torch_sp_workers.py, which imports no JAX), one 4-rank world for
every {fsdp 2, tensor 2} case and one 2-rank world for the {data 2}
restore, each spawned once for the module. Tolerances: the sharded
train step against the port's one-process step, loss rtol 1e-5 and
gradients rel L2 1e-5 (float32 sums in another order); against the JAX
step on a {fsdp 2, tensor 2} mesh, loss rtol 1e-5, AdamW parameters
atol / rtol 1e-6 and Muon's update within 1e-1 relative (bf16 NS5,
tests/test_torch_port_train.py's bounds); the TP cached decode within
JAX's own 3e-4 (tests/test_multichip_serve.py); the ring's head shard
within 1e-5 of JAX's; the cross-topology restore bit-equal.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from owl_audio_exps_tpu.configs import Config as JaxConfig
from owl_audio_exps_tpu.configs import transformer_config as jax_config
from owl_audio_exps_tpu.models.gamerft import GameRFT as JaxGameRFT
from owl_audio_exps_tpu.models.gamerft import GameRFTCore as JaxCore
from owl_audio_exps_tpu.nn.kv_cache import KVCache as JaxKVCache
from owl_audio_exps_tpu.parallel import sharding as jax_sharding
from owl_audio_exps_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from owl_audio_exps_tpu.parallel.mesh import make_mesh as jax_make_mesh
from owl_audio_exps_tpu.trainers.base import \
    build_optimizer as jax_build_optimizer
from owl_audio_exps_tpu.utils.torch_import import import_torch_state_dict
from owl_audio_exps_tpu_torch.configs import Config
from owl_audio_exps_tpu_torch.configs import transformer_config as port_config
from owl_audio_exps_tpu_torch.models.gamerft import GameRFT, GameRFTCore
from owl_audio_exps_tpu_torch.nn.kv_cache import KVCache
from owl_audio_exps_tpu_torch.parallel import mesh as pmesh
from owl_audio_exps_tpu_torch.parallel import sharding
from owl_audio_exps_tpu_torch.utils.weights import params_from_jax

import torch_sp_workers as workers
from torch_port_util import assert_watch, jax_watch_of, numpy_params

TINY = dict(
    model_id="game_rft", n_layers=2, n_heads=4, d_model=64, channels=4,
    sample_size=2, tokens_per_frame=4, n_frames=16, n_buttons=3,
    causal=True, uncond=False, has_audio=False, rope_impl="ortho",
    local_window=4, global_window=None, cfg_prob=0.0, backbone="dit")
MODELS = {"tiny": TINY, "heads3": dict(TINY, n_heads=3, d_model=48)}
MESHES = {"fsdp2_tensor2": dict(fsdp=2, tensor=2), "fsdp4": dict(fsdp=4),
          "tensor4": dict(tensor=4)}


def _model_kw(name):
    if name == "5B":
        # the port reads scan_layers as unrolled blocks; the JAX tree is
        # compared unrolled, where each block's leaves have their shapes
        return dict(Config.from_yaml("configs/dit_v4_5B.yml").model.items(),
                    scan_layers=False)
    return MODELS[name]


def _sizes(mesh):
    return dict(dict(data=1, fsdp=1, tensor=1, seq=1, pipe=1), **mesh)


@functools.lru_cache(maxsize=None)
def _jax_shapes(name):
    """{JAX path: shape} of the model's core, from jax.eval_shape."""
    kw = _model_kw(name)
    cfg = jax_config(**kw)
    p = cfg.sample_size
    x = jax.ShapeDtypeStruct((1, 1, cfg.channels, p, p), jnp.float32)
    t = jax.ShapeDtypeStruct((1, 1), jnp.float32)
    mouse = jax.ShapeDtypeStruct((1, 1, 2), jnp.float32)
    btn = jax.ShapeDtypeStruct((1, 1, cfg.n_buttons), jnp.float32)
    tree = jax.eval_shape(JaxCore(cfg, dtype=jnp.float32).init,
                          jax.random.key(0), x, t, mouse, btn)
    return {"/".join(str(getattr(k, "key", k)) for k in path[1:]):
            tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_rows_of_jax(cols, n_heads, dh):
    """The port's [3, H, Dh] rows of JAX's packed [H, 3, Dh] columns."""
    h, s, e = cols // (3 * dh), (cols // dh) % 3, cols % dh
    return np.sort(s * n_heads * dh + h * dh + e)


# ----------------------------------------------------------- rule table

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("model", ["tiny", "heads3", "5B"])
def test_rule_table_matches_jax(model, mesh):
    kw = _model_kw(model)
    sizes = _sizes(MESHES[mesh])
    jax_mesh = types.SimpleNamespace(shape=sizes)
    want = _jax_shapes(model)
    core = GameRFTCore(port_config(**kw), device="meta", seed=None)
    H = kw["n_heads"]
    dh = kw["d_model"] // H
    seen = set()
    n_sharded = 0
    for name, p in core.named_parameters():
        shape = tuple(p.shape)
        path = sharding.jax_path(name, len(shape))
        kernel = len(shape) == 2
        assert want[path] == (shape[::-1] if kernel else shape), name
        seen.add(path)
        jspec = tuple(jax_sharding.spec_for_path(path, want[path],
                                                 jax_mesh))
        # the port names only the axes that shard (an axis of one rank
        # shards nothing)
        jspec = tuple(a if a is not None and sizes[a] > 1 else None
                      for a in jspec) + (None,) * (len(shape) - len(jspec))
        spec = sharding.param_spec(name, shape, sizes, H)
        assert spec.axes == (jspec[::-1] if kernel else jspec), name
        n_sharded += spec.sharded
        qkv = path.endswith(("attn/qkv/kernel", "attn/qkv/bias"))
        for dim, axis in enumerate(spec.axes):
            if axis is None:
                continue
            n = sizes[axis]
            per = shape[dim] // n
            for k in range(n):
                rows = spec.indices(dim, k).numpy()
                cols = np.arange(k * per, (k + 1) * per)
                if qkv and dim == 0:
                    cols = _port_rows_of_jax(cols, H, dh)
                np.testing.assert_array_equal(rows, cols, err_msg=name)
                if qkv and dim == 0 and H % n == 0:
                    # whole heads: rank k holds heads [k H/n, (k+1) H/n)
                    # of each of q, k and v
                    hs = range(k * H // n, (k + 1) * H // n)
                    heads = sorted(s * H * dh + h * dh + e for s in range(3)
                                   for h in hs for e in range(dh))
                    np.testing.assert_array_equal(rows, heads)
    assert seen == set(want)
    assert n_sharded > 0
    if model == "heads3" and sizes["tensor"] > 1:
        # the guard: the QKV rows shard over tensor (3 * 48 divides), but
        # not by whole heads, which the port refuses to run
        spec = sharding.param_spec("transformer.blocks.0.attn.qkv.weight",
                                   (144, 48), sizes, 3)
        assert spec.axes[0] == "tensor"
        with pytest.raises(ValueError, match="heads"):
            sharding.shard_params(core, pmesh.Mesh(**{
                a: sizes[a] for a in ("data", "fsdp", "tensor")}))


def test_cache_shardings_match_jax():
    jmesh = jax_make_mesh(JaxMeshConfig(data=2, fsdp=2, tensor=2))
    mesh = pmesh.Mesh(data=2, fsdp=2, tensor=2)
    for kw, b in ((TINY, 2), (MODELS["heads3"], 1)):
        want = jax_sharding.cache_shardings(
            JaxKVCache.from_config(jax_config(**kw), batch_size=b,
                                   capacity_frames=8), jmesh)
        cache = KVCache.from_config(port_config(**kw), b, capacity_frames=8,
                                    device="cpu", mesh=pmesh.Mesh())
        got = sharding.cache_shardings(cache, mesh)
        for field in ("k", "v", "lk", "lv"):
            if getattr(cache, field) is None:
                continue
            assert got[field] == tuple(getattr(want, field).spec), field
        assert got["start"] == got["length"] == ()
    # shard_cache keeps rank (data 1, tensor 1)'s batch row and heads
    cache = KVCache.from_config(port_config(**TINY), 2, capacity_frames=8,
                                device="cpu", mesh=pmesh.Mesh())
    cache.k.copy_(torch.randn(cache.k.shape))
    local = sharding.shard_cache(cache, pmesh.Mesh(
        data=2, fsdp=2, tensor=2, data_index=1, tensor_index=1))
    torch.testing.assert_close(local.k, cache.k[:, 1:2, 2:4], rtol=0,
                               atol=0)
    assert local.length is cache.length and local.k.shape[2] == 2


def test_mesh_is_jax_device_order():
    shape = dict(data=2, fsdp=2, tensor=2, seq=1)
    order = np.arange(8).reshape(2, 2, 2, 1, 1)
    for rank in range(8):
        c = pmesh.mesh_coords(shape, rank)
        assert order[c["data"], c["fsdp"], c["tensor"], c["seq"], 0] == rank
        assert pmesh.mesh_rank(shape, c) == rank
    assert pmesh.axis_groups(shape, ("tensor",)) == [[0, 1], [2, 3], [4, 5],
                                                     [6, 7]]
    assert pmesh.axis_groups(shape, ("data", "fsdp")) == [[0, 2, 4, 6],
                                                          [1, 3, 5, 7]]
    m = pmesh.Mesh(data=2, fsdp=2, tensor=2, data_index=1, fsdp_index=1)
    assert (m.batch_rank, m.batch_ranks) == (3, 4)
    # pipe runs since the pipe axis is ported; on one process it wants
    # more processes than it has, as fsdp does
    with pytest.raises(ValueError, match="processes"):
        pmesh.make_mesh(pmesh.MeshConfig(pipe=2))


# --------------------------------------------------- the 4-rank world

def _opt_kwargs(opt):
    """configs/dit_v4_5B.yml's optimizer settings (for AdamW its AdamW
    part), with AdamW's eps raised from 1e-15 to 1e-4: Adam's first step
    turns the sign of a near-zero gradient into +-lr, so a gradient known
    to float32 reassociation would not fix it (ROADMAP Queue 3, "watch";
    the distillation step tests do the same)."""
    kw = dict(Config.from_yaml("configs/dit_v4_5B.yml").train.opt_kwargs
              .items(), adamw_eps=1e-4)
    if opt == "Muon":
        return kw
    return {"lr": kw["adamw_lr"], "betas": kw["adamw_betas"], "eps": 1e-4,
            "weight_decay": kw["adamw_wd"]}


def _train_cfg(tmp, opt, mesh, **train):
    return {"model": dict(TINY, n_frames=8, cfg_prob=0.25),
            "train": dict({"trainer_id": "rft",
                           "data_id": "synthetic_latent",
                           "data_kwargs": {"window_length": 4, "channels": 4,
                                           "sample_size": 2, "n_buttons": 3},
                           "target_batch_size": 4, "batch_size": 2,
                           "opt": opt, "opt_kwargs": _opt_kwargs(opt),
                           "mesh": mesh,
                           "checkpoint_dir": str(tmp / "ckpt"),
                           "save_interval": 1000, "sample_interval": 1000,
                           "log_interval": 1, "vae_scale": 1.0}, **train),
            "wandb": {}}


def _jax_steps(tmp, batch, weights):
    """The JAX step on a {fsdp 2, tensor 2} mesh from the port's seeded
    ``weights`` (carried by the JAX package's import_torch_state_dict):
    the loss, its draws and gradients, then each optimizer's updated
    parameters (clip 10 for AdamW, as the JAX trainer's step)."""
    cfgs = {opt: JaxConfig.from_dict(_train_cfg(tmp, opt, {"fsdp": 2,
                                                          "tensor": 2}))
            for opt in ("AdamW", "Muon")}
    model = JaxGameRFT(cfgs["Muon"].model, dtype=jnp.float32)
    x, mouse, btn = (jnp.asarray(a) for a in batch)
    params = {"params": jax.tree.map(jnp.asarray, import_torch_state_dict(
        weights, TINY["n_heads"]))}
    mesh = jax_make_mesh(JaxMeshConfig(data=1, fsdp=2, tensor=2, devices=4))
    params = jax_sharding.shard_params(params, mesh)

    def loss_and_draw(p):
        out = model.apply(p, x, mouse, btn, return_dict=True,
                          rngs={"noise": jax.random.key(5)})
        return out["diffusion_loss"], out

    (loss, draw), grads = jax.jit(jax.value_and_grad(
        loss_and_draw, has_aux=True))(params)
    p, g = params["params"], grads["params"]
    txs = {opt: jax_build_optimizer(cfg.train, p)
           for opt, cfg in cfgs.items()}

    @jax.jit
    def updates(g, p):
        gnorm = optax.global_norm(g)
        clipped = jax.tree.map(
            lambda a: a * jnp.minimum(1.0, 10.0 / (gnorm + 1e-6)), g)
        return {opt: optax.apply_updates(p, tx.update(
            clipped if opt == "AdamW" else g, tx.init(p), p)[0])
            for opt, tx in txs.items()}

    out = dict(loss=float(loss), params=p, grads=g,
               draws=tuple(np.asarray(draw[k])
                           for k in ("ts", "z_video", "cfg_mask")))
    out.update(updates(g, p))
    # two Muon steps on seeded full-rank gradients, as
    # tests/test_torch_port_train.py's optimizer test takes them
    rs = np.random.RandomState(7)
    rand = [jax.tree.map(lambda a: jnp.asarray(rs.randn(*a.shape).astype(
        np.float32)), p) for _ in range(2)]
    tx = txs["Muon"]
    opt_state, new = tx.init(p), p
    for gr in rand:
        upd, opt_state = jax.jit(tx.update)(gr, opt_state, new)
        new = optax.apply_updates(new, upd)
    out["rand_grads"], out["rand_new"] = rand, new
    return out


# the train steps run train.watch: full (histograms of 16 bins)
WATCH = dict(watch="full", watch_bins=16)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """Every {fsdp 2, tensor 2} case in one 4-rank gloo world: the AdamW
    and Muon train steps on the JAX step's weights and draws, the TP
    cached decode, and 2 steps of the trainer's own loop with a save."""
    tmp = tmp_path_factory.mktemp("world4")
    rs = np.random.RandomState(3)
    b, n = 4, 4
    batch = (rs.randn(b, n, 4, 2, 2).astype(np.float32),
             rs.randn(b, n, 2).astype(np.float32),
             (rs.rand(b, n, 3) > 0.5).astype(np.float32))
    model = GameRFT(port_config(**dict(TINY, n_frames=8, cfg_prob=0.25)),
                    dtype=torch.float32, device="cpu", seed=0)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    js = _jax_steps(tmp, batch, sd)
    jobs, one = [], {}
    for opt in ("AdamW", "Muon"):
        jobs.append((opt, "sharded_step", (
            _train_cfg(tmp, opt, {"fsdp": 2, "tensor": 2}, **WATCH), sd,
            batch, js["draws"])))
        one[opt] = workers.sharded_step(_train_cfg(tmp, opt, {}, **WATCH),
                                        sd, batch, js["draws"])
    # the TP decode of tests/test_multichip_serve.py, on the same weights
    core = JaxCore(jax_config(**TINY), dtype=jnp.float32)
    rs = np.random.RandomState(0)
    dec_in = (rs.randn(2, 8, 4, 2, 2).astype(np.float32),
              rs.rand(2, 8).astype(np.float32),
              rs.randn(2, 8, 2).astype(np.float32),
              (rs.rand(2, 8, 3) > 0.5).astype(np.float32))
    jparams = {"params": js["params"]["core"]}
    dec_sd = {k[len("core."):]: v for k, v in sd.items()}
    jobs.append(("decode", "tp_decode", (TINY, dec_sd, dec_in,
                                         {"fsdp": 2, "tensor": 2})))
    rand = [{k: v.numpy() for k, v in params_from_jax(numpy_params(
        {"core": g["core"]}), TINY["n_heads"]).items()}
        for g in js["rand_grads"]]
    jobs.append(("opt", "sharded_opt_steps", (
        _train_cfg(tmp, "Muon", {"fsdp": 2, "tensor": 2}), sd, rand)))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # the ranks' bf16 NS5 runs on one thread
    try:
        one["opt"] = workers.sharded_opt_steps(_train_cfg(tmp, "Muon", {}),
                                               sd, rand)
    finally:
        torch.set_num_threads(threads)
    save_cfg = _train_cfg(tmp, "Muon", {"fsdp": 2, "tensor": 2},
                          save_interval=2)
    jobs.append(("save", "train_and_save", (save_cfg, 2)))
    rs = np.random.RandomState(9)
    coll = (rs.randn(4, 6).astype(np.float32),
            rs.randn(4, 12).astype(np.float32))
    jobs.append(("collectives", "collectives", coll))
    res = workers.run_ranks(workers.run_jobs, 4, tmp / "ranks", jobs)
    return dict(res=res, jax=js, one=one, tmp=tmp, sd=sd,
                dec=(core, jparams, dec_in), save_cfg=save_cfg, coll=coll)


def test_collectives_and_their_backwards(world4):
    """parallel/dist.py on the tensor groups of {fsdp 2, tensor 2} (ranks
    {0, 1} and {2, 3}), each rank holding row ``rank`` of x as [2, 3]
    and taking the leading elements of row ``rank`` of g as cotangent:
    all-gather (backward: the reduce-scatter of the cotangents),
    reduce-scatter (backward: the all-gather), all-reduce (backward: the
    identity) and the identity whose backward all-reduces."""
    x, g = world4["coll"]
    for rank, r in enumerate(world4["res"]):
        got = r["collectives"]
        pair = [rank - rank % 2, rank - rank % 2 + 1]
        t, mine = rank % 2, x[rank].reshape(2, 3)
        xs = [x[p].reshape(2, 3) for p in pair]
        gs = [g[p] for p in pair]
        want = {
            "all_gather": (np.concatenate(xs),
                           sum(gi.reshape(4, 3)[2 * t:2 * t + 2]
                               for gi in gs)),
            "reduce_scatter": ((xs[0] + xs[1])[t:t + 1],
                               np.concatenate([gi[:3].reshape(1, 3)
                                               for gi in gs])),
            "all_reduce": (xs[0] + xs[1], g[rank][:6].reshape(2, 3)),
            "copy_to_group": (mine, (gs[0] + gs[1])[:6].reshape(2, 3))}
        for name, (y, grad) in want.items():
            np.testing.assert_allclose(got[name][0], y, rtol=1e-6,
                                       err_msg=name)
            np.testing.assert_allclose(got[name][1], grad, rtol=1e-6,
                                       atol=1e-6, err_msg=name)


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("opt", ["AdamW", "Muon"])
def test_sharded_step_matches_one_process(world4, opt):
    ref = world4["one"][opt]
    for r in world4["res"]:
        got = r[opt]
        assert got["mesh"][:3] == (1, 2, 2)
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        assert set(got["grads"]) == set(ref["grads"])
        for name, g in ref["grads"].items():
            assert _rel(got["grads"][name], g) <= 1e-5, name
        if opt == "AdamW":
            np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                                       rtol=1e-5)
    # the slices are genuinely distributed: qkv holds 1/4 of its rows x
    # columns, adaln 1/2 of its columns (fsdp only)
    shapes = world4["res"][0][opt]["local_shapes"]
    assert shapes["core.transformer.blocks.0.attn.qkv.weight"] == (96, 32)
    assert shapes["core.transformer.blocks.0.adaln1.fc.weight"] == (128, 32)
    assert shapes["core.transformer.blocks.0.mlp.fc2.bias"] == (64,)
    assert [r[opt]["mesh"][3] for r in world4["res"]] == [0, 0, 1, 1]


@pytest.mark.parametrize("opt", ["AdamW", "Muon"])
def test_sharded_watch_matches_one_process_and_jax(world4, opt):
    """``train.watch: full`` at {fsdp 2, tensor 2}: every rank's dict is
    the same, equals the one-process step's (norms rtol 1e-5, histogram
    counts exact) and the JAX package's ``watch_metrics`` of the same
    parameters (the step's initial weights) and clipped gradients."""
    ref = world4["one"][opt]["watch"]
    assert any(k.startswith("watch/grad_norm/core/") for k in ref)
    first = world4["res"][0][opt]["watch"]
    for r in world4["res"]:
        assert_watch(r[opt]["watch"], ref)
        for k, v in first.items():
            np.testing.assert_array_equal(r[opt]["watch"][k], v)
    got = world4["res"][0][opt]
    want = jax_watch_of(world4["sd"], got["grads"], WATCH["watch_bins"])
    assert_watch(first, want)
    n = sum(v.size for v in world4["sd"].values())
    assert int(first["watch_hist/params"].sum()) == n
    assert int(first["watch_hist/grads"].sum()) == n


def _port(tree):
    return params_from_jax(numpy_params({"core": tree["core"]}),
                           TINY["n_heads"])


def _muon_labels(named):
    from owl_audio_exps_tpu_torch.muon import muon_adamw_labels
    return muon_adamw_labels(list(named.items()),
                             _opt_kwargs("Muon")["adamw_keys"])


@pytest.mark.parametrize("opt", ["AdamW", "Muon"])
def test_sharded_step_matches_jax(world4, opt):
    """The sharded step against JAX's: the loss, the gradients (as
    tests/test_torch_port_train.py bounds them) and the AdamW-updated
    parameters. A Muon update is held by its direction (cosine > 0.8, as
    tests/test_torch_port_mmdit.py holds the MMDiT step's): a real
    gradient of this tiny model is nearly low-rank (its 21st singular
    value 1e-4 to 2e-8 of its first), and bf16 NS5 lifts the rounding in
    its near-null directions, so the two frameworks' updates differ
    0.25-0.58 relative even from the same gradient (ROADMAP Queue 3,
    "watch"); test_sharded_muon_matches_one_process_and_jax holds Muon
    over shards to 1e-1 on full-rank gradients, as the existing
    optimizer test does."""
    js = world4["jax"]
    got = world4["res"][0][opt]
    np.testing.assert_allclose(got["loss"], js["loss"], rtol=1e-5)
    want, before, grads = _port(js[opt]), _port(js["params"]), \
        _port(js["grads"])
    labels = _muon_labels(before) if opt == "Muon" else {}
    for name, w in want.items():
        np.testing.assert_allclose(got["grads"][name], grads[name].numpy(),
                                   atol=1e-5, rtol=1e-3, err_msg=name)
        if labels.get(name) == "muon":
            d_port = (got["params"][name] - before[name].numpy()).ravel()
            d_jax = (w - before[name]).numpy().ravel()
            cos = d_port @ d_jax / (np.linalg.norm(d_port)
                                    * np.linalg.norm(d_jax))
            assert cos > 0.8, (name, cos)
        else:
            np.testing.assert_allclose(got["params"][name], w.numpy(),
                                       atol=1e-6, rtol=1e-6, err_msg=name)


def test_sharded_muon_matches_one_process_and_jax(world4):
    """Two Muon + AdamW steps (configs/dit_v4_5B.yml's settings) over the
    {fsdp 2, tensor 2} shards from seeded full-rank gradients: each rank
    gathers the momentum-updated gradient, runs NS5 on the whole matrix
    and keeps its slice, which equals the one-process optimizer (on one
    thread, as the ranks) bit for bit; against JAX's optimizer on its
    sharded mesh, Muon's update within 1e-1 relative and AdamW to 1e-6
    (tests/test_torch_port_train.py's bounds)."""
    js = world4["jax"]
    ref = world4["one"]["opt"]
    want, before = _port(js["rand_new"]), _port(js["params"])
    labels = _muon_labels(before)
    assert set(labels.values()) == {"muon", "adamw"}
    for r in world4["res"]:
        _assert_same(r["opt"], ref)
    for name, w in want.items():
        p = ref[name]
        if labels[name] == "muon":
            d_port, d_jax = p - before[name].numpy(), (w - before[name]).numpy()
            assert np.linalg.norm(d_port - d_jax) < \
                1e-1 * np.linalg.norm(d_jax), name
        else:
            np.testing.assert_allclose(p, w.numpy(), atol=1e-6, rtol=1e-6,
                                       err_msg=name)


def test_tp_cached_decode_matches_jax(world4):
    core, params, dec_in = world4["dec"]
    x, t, mouse, btn = (jnp.asarray(a) for a in dec_in)
    n = x.shape[1]
    mesh = jax_make_mesh(JaxMeshConfig(data=1, fsdp=2, tensor=2, devices=4))
    params = jax_sharding.shard_params(params, mesh)
    full, _ = jax.jit(lambda p: core.apply(p, x, t, mouse, btn))(params)
    cache = jax_sharding.shard_cache(JaxKVCache.from_config(
        jax_config(**TINY), batch_size=2, capacity_frames=12,
        dtype=jnp.float32), mesh)
    _, cache = jax.jit(lambda p, c: core.apply(
        p, x[:, :n - 1], t[:, :n - 1], mouse[:, :n - 1], btn[:, :n - 1],
        kv_cache=c, write=True))(params, cache)
    ring = np.asarray(cache.k)
    H = TINY["n_heads"]
    for r in world4["res"]:
        dec = r["decode"]
        np.testing.assert_allclose(dec["last"][:, 0], np.asarray(full[:, -1]),
                                   atol=3e-4)
        # this rank's ring holds exactly JAX's head shard
        t_idx = dec["tensor_index"]
        shard = ring[:, :, t_idx * H // 2:(t_idx + 1) * H // 2]
        assert dec["ring_k"].shape == shard.shape
        np.testing.assert_allclose(dec["ring_k"], shard, atol=1e-5, rtol=0)


def test_tp_serve_ticks_keep_the_counters(world4):
    """Three ticks (write + decoding) on the head-sharded ring, as JAX's
    donated serve tick: the ring keeps H / T heads, the counters advance
    alike on every rank, and every rank computes the same output."""
    res = [r["decode"] for r in world4["res"]]
    for dec in res:
        assert dec["tick_length"] == 3 * TINY["tokens_per_frame"]
        assert dec["tick_ring_shape"][2] == TINY["n_heads"] // 2
        assert all(np.isfinite(o).all() for o in dec["ticks"])
        for a, b in zip(dec["ticks"], res[0]["ticks"]):
            np.testing.assert_array_equal(a, b)


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=str(k))


@pytest.fixture(scope="module")
def saved(world4):
    res = world4["res"]
    assert all(r["save"]["step"] == 2 for r in res)
    assert len(res[0]["save"]["losses"]) == 2
    assert not any(r["save"]["losses"] for r in res[1:])  # rank 0 logs
    path = str(world4["tmp"] / "ckpt" / "step_2.pt")
    from owl_audio_exps_tpu_torch.utils.checkpoints import load_checkpoint
    raw = load_checkpoint(path)
    want = dict(params={k: v.numpy() for k, v in raw["params"].items()},
                ema={k: v.numpy() for k, v in raw["ema_params"].items()},
                moments=workers._opt_arrays(raw["opt_state"]))
    return path, want, raw


def test_checkpoint_holds_the_full_logical_state(saved):
    path, want, raw = saved
    assert set(raw) == {"params", "ema_params", "opt_state", "step"}
    assert raw["params"]["core.transformer.blocks.0.attn.qkv.weight"].shape \
        == (192, 64)
    # the moments are whole too: Muon's momentum of every matrix and
    # AdamW's two of the rest, each of its parameter's full shape
    full = {v.shape for v in want["params"].values()}
    assert want["moments"] and all(v.shape in full
                                   for v in want["moments"].values())
    assert (192, 64) in {v.shape for v in want["moments"].values()}


@pytest.mark.parametrize("mesh", ["one_process", "data2"])
def test_cross_topology_restore_is_bit_equal(world4, saved, mesh, tmp_path):
    path, want, _ = saved
    cfg = dict(world4["save_cfg"])
    cfg["train"] = dict(cfg["train"], save_interval=1000,
                        checkpoint_dir=str(tmp_path / "ckpt"))
    if mesh == "one_process":
        cfg["train"]["mesh"] = {}
        got = workers.restore_and_step(cfg, path)
    else:
        cfg["train"]["mesh"] = {"data": 2}
        got = workers.run_ranks(workers.run_jobs, 2, tmp_path / "ranks",
                                [("r", "restore_and_step", (cfg, path))])
        got = got[0]["r"]
    r = got["restored"]
    _assert_same(r["params"], want["params"])
    _assert_same(r["ema"], want["ema"])
    _assert_same(r["moments"], want["moments"])
    assert r["step"] == 2 and got["step"] == 3
    assert len(got["losses"]) == 1 and np.isfinite(got["losses"][0])
