"""Every public name of the JAX package has a counterpart in the port.

Both packages are read with ``ast`` and neither is imported. For each
module of ``owl_audio_exps_tpu/`` (and each root ``inference/`` script,
whose counterparts live in ``owl_audio_exps_tpu_torch/inference/``) every
public top-level ``def`` and ``class`` must be defined, assigned or
imported at the top level of the port module at the mirrored path, or
stand in ``NO_COUNTERPART`` with the reason it has none. A name the JAX
package gains with neither fails the test, and so does a stale entry of
the table.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX, PORT = "owl_audio_exps_tpu", "owl_audio_exps_tpu_torch"

_OPTAX = "the port's optimizers are torch.optim classes (muon.py `Muon`, "
_SCAN = ("the port keeps its blocks unrolled and reads the scanned layout "
         "(utils/weights.py `unstack_groups`)")
_JIT = "jit and its caches have no counterpart in eager PyTorch"
_SHARDING = ("a GSPMD sharding of a global array; the port's ranks hold "
             "their slices (parallel/sharding.py `ShardSpec`)")

# {JAX module (repo-relative): {name: why the port has no counterpart}}
NO_COUNTERPART = {
    "owl_audio_exps_tpu/muon.py": {
        "muon": _OPTAX + "an optax transform is `Muon`)",
        "adamw_lowmem": _OPTAX + "bf16 moments are `AdamW(state_dtype=)`)",
        "MuonState": _OPTAX + "whose state lives in `Optimizer.state`)",
        "AdamWLowMemState": _OPTAX + "whose state lives in "
                                     "`Optimizer.state`)",
    },
    "owl_audio_exps_tpu/ops/splash.py": {
        "FrameMask": "a mask object of the library splash kernel; K1 "
                     "computes the frame mask in csrc/hopper_attention.cuh",
        "largest_divisor_block": "a splash block-size rule; K1 takes any L",
        "pad_to_block": "pads L to a splash block; K1 takes any L",
        "splash_available": "asks for a TPU; nn/attn.py `use_splash_path` "
                            "asks for a CUDA tensor",
    },
    "owl_audio_exps_tpu/nn/attn.py": {
        "DiTGroup": "the scan_layers unit; " + _SCAN,
        "use_scan_layers": "chooses the scanned stack; " + _SCAN,
        "QKVProj": "a flax parameter layout for split-stream compute; the "
                   "port's fused QKV is one `Linear`",
        "sequenced_block": "an XLA optimization barrier around a remat "
                           "block; torch.utils.checkpoint already runs the "
                           "recompute in order",
    },
    "owl_audio_exps_tpu/nn/layers.py": {
        "torch_linear_kernel_init": "flax initializers drawing torch's "
                                    "init; nn/layers.py `Linear` draws it",
        "torch_linear_bias_init": "as torch_linear_kernel_init",
        "scaled_kaiming_normal_init": "`Linear(init='scaled_kaiming')`",
    },
    "owl_audio_exps_tpu/parallel/context.py": {
        "shard_attention": "a shard_map wrapper of global arrays; each "
                           "rank calls `sp_attention` on its slice",
    },
    "owl_audio_exps_tpu/parallel/mesh.py": {
        "batch_sharding": _SHARDING,
        "replicated": _SHARDING,
    },
    "owl_audio_exps_tpu/parallel/sharding.py": {
        "param_shardings": _SHARDING + "; `param_spec` per parameter",
        "pin_tail_replicated": "a GSPMD layout hint on an activation; "
                               "eager PyTorch propagates no sharding",
    },
    "owl_audio_exps_tpu/data/native_loader.py": {
        "native_available": "the port builds its gather or raises "
                            "(`load_library`); no fallback hides it",
    },
    "owl_audio_exps_tpu/utils/checkpoints.py": {
        "wait_for_checkpoints": "orbax's asynchronous writes; "
                                "`save_checkpoint` writes synchronously",
    },
    "owl_audio_exps_tpu/utils/layer_stacking.py": {
        "stack_block_params": _SCAN,
        "unstack_block_params": _SCAN,
        "convert_params": _SCAN,
    },
    "owl_audio_exps_tpu/utils/torch_import.py": {
        "load_torch_file": "utils/checkpoints.py `load_torch_file`",
        "normalize_torch_keys": "done by utils/checkpoints.py "
                                "`load_torch_file`",
        "import_torch_state_dict": "the port's state_dict is the torch "
                                   "layout; the reverse is "
                                   "utils/weights.py `params_from_jax`",
        "export_torch_state_dict": "utils/weights.py `params_from_jax`",
        "permute_qkv_rows": "the port keeps the torch row order",
        "inverse_permute_qkv_rows": "utils/weights.py "
                                    "`inverse_permute_qkv_rows`",
        "import_audio_vae": "the port's VAEs load torch state_dicts; "
                            "utils/weights.py `vae_params_from_jax`",
        "import_dcae_decoder": "as import_audio_vae",
        "assert_tree_matches": "flax tree checks; `load_state_dict("
                               "strict=True)` checks the port's",
    },
    "owl_audio_exps_tpu/sampling/common.py": {
        "JitCache": _JIT + "; the samplers keep their CUDA-graph loops",
        "randn_like": "sampling/common.py `randn`",
    },
}


def _public(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")}


def _defined(path):
    """Every name bound at the module's top level."""
    if not os.path.exists(path):
        return set()
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    out = set()
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in n.names)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            out.update(t.id for t in targets if isinstance(t, ast.Name))
    return out


def _pairs():
    """(JAX module, its port module), repo-relative."""
    out = []
    for root, _, files in os.walk(os.path.join(REPO, JAX)):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)
                out.append((rel, PORT + rel[len(JAX):]))
    for f in sorted(os.listdir(os.path.join(REPO, "inference"))):
        if f.endswith(".py"):
            out.append((f"inference/{f}", f"{PORT}/inference/{f}"))
    return sorted(out)


PAIRS = _pairs()


@pytest.mark.parametrize("jax_mod,port_mod", PAIRS,
                         ids=[j for j, _ in PAIRS])
def test_every_public_name_has_a_port_counterpart(jax_mod, port_mod):
    names = _public(os.path.join(REPO, jax_mod))
    excused = NO_COUNTERPART.get(jax_mod, {})
    missing = names - _defined(os.path.join(REPO, port_mod)) - set(excused)
    assert not missing, (
        f"{jax_mod}: {sorted(missing)} have no counterpart in {port_mod} "
        "and no reason in NO_COUNTERPART")
    stale = set(excused) - names
    assert not stale, f"NO_COUNTERPART names {sorted(stale)} not in {jax_mod}"
    ported = set(excused) & _defined(os.path.join(REPO, port_mod))
    assert not ported, f"{sorted(ported)} are ported: drop their reasons"


def test_the_reason_table_names_real_modules():
    mods = {j for j, _ in PAIRS}
    assert set(NO_COUNTERPART) <= mods
    assert all(why.strip() for m in NO_COUNTERPART.values()
               for why in m.values())
