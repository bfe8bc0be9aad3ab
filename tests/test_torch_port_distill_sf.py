"""The port's Self-Forcing rollout (trainers/self_forcing.py) against the
JAX package's, on the CPU at tests/test_distill.py's tiny width: a
4-frame context, 2 rollout frames of up to ``rollout_steps`` 2 Euler
steps each, through the ring KV cache, which evicts the oldest frame at
every re-encode.

The port gets the JAX rollout's draws, replayed from the same key splits
(the control permutations, each frame's initial noise and step count
``end``); the keys are picked so that the frames take ``end`` (1, 2) and
(2, 1). The JAX package unrolls both steps and masks the inactive one;
the port runs only the active ones. Tolerances: the window within one
bfloat16 rounding step (rtol 2^-8; the generated frames are bfloat16 in
both); the DMD loss through the rollout rtol 1e-5, its gradients w.r.t.
the student atol 1e-5, rtol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_audio_exps_tpu_torch.trainers.causvid import LossDraws
from owl_audio_exps_tpu_torch.trainers.self_forcing import SelfForceDraws
from owl_audio_exps_tpu_torch.utils.controls import doublings_to_length

from torch_port_util import LOSS_RTOL, assert_grads, batch, t, trainers

W, R, STEPS = 4, 2, 2
BF16_STEP = 2.0 ** -8


def sf_draws(key, b, item, n_ctrl) -> SelfForceDraws:
    """The JAX rollout's draws under ``key``: split -> (perm, frames); one
    permutation per doubling of the controls; per frame split -> (init,
    steps)."""
    r_perm, r_frames = jax.random.split(key)
    perms = []
    for _ in range(doublings_to_length(n_ctrl, W + R)):
        r_perm, r = jax.random.split(r_perm)
        perms.append(np.asarray(jax.random.permutation(r, b)))
    init, ends = [], []
    for fr in jax.random.split(r_frames, R):
        r_init, r_steps = jax.random.split(fr)
        init.append(np.asarray(jax.random.normal(r_init, (b, 1) + item,
                                                 jnp.float32)))
        ends.append(int(jax.random.randint(r_steps, (), 1, STEPS + 1)))
    return SelfForceDraws(t(np.stack(perms)).long(), t(np.stack(init)),
                          tuple(ends))


def loss_key(ends):
    """The first key whose DMD loss draws give the frames ``ends``."""
    for seed in range(100):
        key = jax.random.key(seed)
        r_roll = jax.random.split(key, 3)[0]
        if sf_draws(r_roll, 2, (4, 2, 2), W).ends == ends:
            return key
    raise AssertionError(f"no key gives {ends}")


def sf_loss_draws(key, shape) -> LossDraws:
    b, n = shape[:2]
    r_roll, r_ts, r_z = jax.random.split(key, 3)
    return LossDraws(sf_draws(r_roll, b, tuple(shape[2:]), n),
                     t(jax.nn.sigmoid(jax.random.normal(r_ts, (b, n)))),
                     t(jax.random.normal(r_z, shape, jnp.float32)))


# (ends, model n_frames): n_frames 4 == the context, so the rollout frames
# sit at RoPE positions past the table (test_distill.py's
# test_sforce_rollout_past_n_frames_finite)
CASES = {"end_1_2": ((1, 2), 8), "end_2_1": ((2, 1), 8),
         "past_n_frames": ((2, 1), 4)}


def _setup(tmp_path, case):
    ends, n_frames = CASES[case]
    jtr, js, ptr, ps = trainers(tmp_path, "sforce_vid",
                                model=dict(n_frames=n_frames))
    vid, mouse, btn = batch(11)
    key = loss_key(ends)
    draws = sf_loss_draws(key, vid.shape)
    assert draws.rollout.ends == ends
    return jtr, js, ptr, ps, (vid, mouse, btn), key, draws


@pytest.mark.parametrize("case", list(CASES))
def test_sforce_rollout_matches_jax(tmp_path, case):
    jtr, js, ptr, ps, (vid, mouse, btn), key, draws = _setup(tmp_path, case)
    jvid = (jnp.asarray(vid) / 0.63).astype(jnp.bfloat16)
    r_roll = jax.random.split(key, 3)[0]
    want = jax.jit(lambda p: jtr.get_rollouts(
        p, jvid, jnp.asarray(mouse), jnp.asarray(btn), r_roll,
        with_grad=False))(js.student_params)
    with torch.no_grad():
        got = ptr.get_rollouts(ps.student, ptr.scaled_video(t(vid)),
                               t(mouse), t(btn), False, draws.rollout)
    window, mask, m, b, reg = got
    assert window.shape == (2, W, 4, 2, 2) and window.dtype == torch.float32
    assert torch.isfinite(window).all()
    np.testing.assert_allclose(window.numpy(), np.asarray(want[0]),
                               rtol=BF16_STEP, atol=1e-6)
    assert mask.tolist() == np.asarray(want[1]).tolist()
    assert mask[:, -R:].all() and not mask[:, :-R].any()
    for a, b_ in ((m, want[2]), (b, want[3]), (reg, want[4])):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b_, np.float32),
                                   rtol=BF16_STEP, atol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_sforce_dmd_gradients_through_the_rollout_match_jax(tmp_path,
                                                            case):
    """The DMD loss of the Self-Forcing trainer and its gradient w.r.t.
    the student, which flows through the cached decoding forward of each
    frame's last step only."""
    jtr, js, ptr, ps, (vid, mouse, btn), key, draws = _setup(tmp_path, case)
    jb = tuple(jnp.asarray(a) for a in (vid, mouse, btn))
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda sp: jtr.dmd_loss(sp, js.critic_params, jb, key),
        has_aux=True))(js.student_params)
    pl, pm = ptr.dmd_loss(ps.student, ps.critic,
                          [t(a) for a in (vid, mouse, btn)], draws)
    pl.backward()
    assert float(jl) > 0
    np.testing.assert_allclose(pl.item(), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(pm["dmd_loss"].item(), float(jm["dmd_loss"]),
                               rtol=LOSS_RTOL)
    assert_grads(ps.student.named_parameters(), jg)
    # most parameters take gradient through the final step
    nonzero = [p.grad.abs().max() > 0 for p in ps.student.parameters()]
    assert sum(nonzero) > len(nonzero) // 2
