"""The port's distillation trainers over several processes
(trainers/distill_common.py and the three trainers under a mesh) against
the port's one-process step, on the CPU.

The spec is tests/test_multichip_dryrun.py
``test_distill_trainers_sharded_2x2x2`` (the three cores and both
optimizer states placed by the mesh rules; one step of each trainer),
cut to the 4 ranks of the gloo harness: ``causvid_vid`` and
``sforce_vid`` at {fsdp 2, tensor 2} and ``ode_distill_vid`` at {data 2,
tensor 2}, all in one world (tests/torch_sp_workers.py). Each rank
takes its batch rank's row of a 2-row batch with the draws handed in
(the Self-Forcing controls doubled by the identity permutation, which
each rank's row keeps); one process takes both rows. The metrics are
held to the losses' LOSS_RTOL (1e-5) of tests/torch_port_util.py, the
student's and the critic's parameters and the student's EMA after the
step to its STATE_ATOL (1e-6) with AdamW's eps at 1e-4 (ROADMAP Queue
3's watch item on Adam's first step, as the existing distillation
tests: the tensor ranks sum float32 partials in another order); every
core is truly sharded and finite.
"""

import numpy as np
import pytest
import torch

from owl_audio_exps_tpu_torch.configs import Config
from owl_audio_exps_tpu_torch.models.gamerft import GameRFTCore
from owl_audio_exps_tpu_torch.trainers.causvid import LossDraws, RolloutDraws
from owl_audio_exps_tpu_torch.trainers.ode_distill import ODEDraws
from owl_audio_exps_tpu_torch.trainers.self_forcing import SelfForceDraws

import torch_sp_workers as workers
from torch_port_util import LOSS_RTOL, MODEL, STATE_ATOL, raw_cfg

CASES = {"causvid_vid": {"fsdp": 2, "tensor": 2},
         "sforce_vid": {"fsdp": 2, "tensor": 2},
         "ode_distill_vid": {"data": 2, "tensor": 2}}
B, W, R = 2, 4, 2


def _cfg(tmp, trainer_id, mesh):
    return Config.from_dict(raw_cfg(
        tmp, trainer_id, opt_kwargs={"lr": 1e-3, "eps": 1e-4},
        d_opt_kwargs={"lr": 2e-3, "eps": 1e-4}, mesh=mesh, ode_steps=3,
        subsample=0.5)).to_dict()


def _inputs(trainer_id):
    """(cores, batch, draws) of one step over the whole batch."""
    gen = torch.Generator().manual_seed(4)
    cfg = Config.from_dict({"model": MODEL}).model
    cores = {key: {n: p.detach().numpy() for n, p in GameRFTCore(
        cfg, dtype=torch.float32, device="cpu", seed=seed).state_dict()
        .items()} for key, seed in (("student", 0), ("critic", 2),
                                    ("teacher", 1))}
    rs = np.random.RandomState(6)
    batch = (rs.randn(B, W, 4, 2, 2).astype(np.float32),
             rs.randn(B, W, 2).astype(np.float32),
             (rs.rand(B, W, 3) > 0.5).astype(np.float32))
    shape = (B, W, 4, 2, 2)

    def loss_draws():
        if trainer_id == "sforce_vid":
            # one doubling of the controls, by the identity permutation
            rollout = SelfForceDraws(
                torch.arange(B)[None],
                torch.randn((R, B, 1) + shape[2:], generator=gen), (1, 2))
        else:
            rollout = RolloutDraws(
                torch.rand(B, W, generator=gen) < 0.5,
                torch.tensor([1.0, 0.5])[torch.randint(2, (B, W),
                                                       generator=gen)],
                torch.randn(shape, generator=gen))
        return LossDraws(rollout, torch.sigmoid(torch.randn(
            B, W, generator=gen)), torch.randn(shape, generator=gen))

    if trainer_id == "ode_distill_vid":
        draws = {"student": ODEDraws(torch.randn(shape, generator=gen),
                                     torch.tensor([True, False, True]))}
    else:
        draws = {"critic": loss_draws(), "student": loss_draws()}
    return cores, batch, draws


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("distill4")
    jobs, one = [], {}
    for trainer_id, mesh in CASES.items():
        args = _inputs(trainer_id)
        jobs.append((trainer_id, "distill_step",
                     (_cfg(tmp, trainer_id, mesh),) + args))
        one[trainer_id] = workers.distill_step(_cfg(tmp, trainer_id, {}),
                                               *args)
    res = workers.run_ranks(workers.run_jobs, 4, tmp / "ranks", jobs)
    return dict(res=res, one=one)


@pytest.mark.parametrize("trainer_id", list(CASES))
def test_sharded_distill_step_matches_one_process(trainer_id, world):
    one = world["one"][trainer_id]
    mesh = CASES[trainer_id]
    for rank, r in enumerate(world["res"]):
        got = r[trainer_id]
        assert got["mesh"][:3] == (mesh.get("data", 1), mesh.get("fsdp", 1),
                                   mesh.get("tensor", 1))
        assert set(got["metrics"]) == set(one["metrics"])
        for k, v in one["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=LOSS_RTOL,
                                       atol=1e-7, err_msg=k)
        keys = ("student", "ema") + (("critic",) if trainer_id !=
                                     "ode_distill_vid" else ())
        for key in keys:
            for name, want in one[key].items():
                np.testing.assert_allclose(got[key][name], want,
                                           atol=STATE_ATOL, rtol=0,
                                           err_msg=f"{key} {name}")
        # every core truly sharded (the rules split something of each),
        # and finite
        for key, shapes in got["local_shapes"].items():
            full = one["local_shapes"][key]
            assert set(shapes) == set(full)
            assert any(shapes[n] != full[n] for n in shapes), key
        assert got["finite"]
