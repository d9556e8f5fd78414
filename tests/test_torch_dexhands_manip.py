"""Port parity: the Bi-DexterousHands manipulation family
(``envs/dexhands_jax/manip.py``: hinge and table tasks) against the JAX env.

Each of the 14 tasks resets from the JAX draws and runs 4 env steps of
random actions on both sides, each on its own state (``free_steps`` of
``tests/test_torch_dexhands.py``): states, observations and rewards at rtol
1e-4 / atol 1e-5, ``won``, dones and bad masks equal. The fingertips'
velocities, the hinge and table contact forces and a substep are held at
rtol 1e-5 / atol 1e-6 from the same states. Success ends an episode here
(done, not bad), unlike the catch family.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harl_tpu.envs.dexhands_jax import manip as jma
from harl_tpu_torch.envs import make_env
from harl_tpu_torch.envs.core import auto_reset_step
from harl_tpu_torch.envs.dexhands_jax import manip as tma

from tests.test_torch_dexhands import (KIN_ATOL, KIN_RTOL, STEPS, _close, _noise, free_steps,
                                       jax_fns)
from tests.torch_replay import _step_reset_keys


@pytest.mark.parametrize("task", jma.DEXHANDS_MANIP_TASKS)
def test_manip_tasks_reset_and_step_like_jax(task):
    worst, ts, _, _ = free_steps(task)
    print(f"{task}: worst element over {STEPS} steps {worst:.3f} of the tolerance")
    assert worst <= 1.0
    if jma.MANIP_TASKS[task]["kind"] == "hinge":   # one dummy object row, as in JAX
        assert tuple(ts.obj_pos.shape) == (8, 1, 3) and not ts.obj_pos.any()


@pytest.mark.parametrize("task", ["ShadowHandDoorOpenOutward", "ShadowHandBlockStack"])
def test_tip_velocities_and_substep_match_jax(task):
    """Fingertips and their velocities against ``jax.jvp`` of the JAX
    ``_fingertips`` (the table hands mounted lower), joints at and past the
    flexion limits included; then a substep with the tips on the handle or
    the blocks."""
    tenv = make_env("dexhands_jax", {"task": task}, device="cpu")
    jenv = jma.make_manip({"task": task})
    rng = np.random.default_rng(7)
    theta = rng.uniform(-0.5, 2.0, (8, 2, 20)).astype(np.float32)
    theta[:, :, 1::4] = np.float32(jma.FLEX_HI)
    theta[:, :, 3::4] = np.float32(jma.FLEX_LO)
    theta_dot = rng.normal(0.0, 5.0, (8, 2, 20)).astype(np.float32)
    tips, tips_v = tenv._tips(torch.from_numpy(theta), torch.from_numpy(theta_dot))
    for h in range(2):
        pos, fwd, up = jenv._hand(h)
        jt, jv = jax.vmap(lambda th, td: jax.jvp(
            lambda x: jma._fingertips(x, pos, fwd, up), (th,), (td,)))(theta[:, h],
                                                                     theta_dot[:, h])
        _close(tips[:, h], jt, KIN_RTOL, KIN_ATOL)
        _close(tips_v[:, h], jv, KIN_RTOL, KIN_ATOL)
    keys = jax.random.split(jax.random.PRNGKey(1), 8)
    ts, _ = tenv.reset(_noise(tenv, keys))
    # curl the fingers onto the handle or the blocks
    theta = rng.uniform(0.0, 1.5, (8, 2, 20)).astype(np.float32)
    tgt = torch.from_numpy(rng.uniform(-0.2, 1.7, (8, 2, 20)).astype(np.float32))
    ts = ts._replace(theta=torch.from_numpy(theta), hinge_vel=torch.full((8,), 0.5))
    out_t = tenv._substep(ts.theta, tgt, ts.hinge, ts.hinge_vel, ts.obj_pos, ts.obj_vel)
    out_j = jax.jit(jax.vmap(jenv._substep))(*(jnp.asarray(x.numpy()) for x in (
        ts.theta, tgt, ts.hinge, ts.hinge_vel, ts.obj_pos, ts.obj_vel)))
    for a, b in zip(out_t, out_j):
        _close(a, b, KIN_RTOL, KIN_ATOL)


def test_success_terminates_and_drop_penalises_like_jax():
    """Hinge: a door at its goal angle ends its episode with ``won`` (done,
    not bad); table: a block pushed off the table is dropped; the horizon's
    last step truncates. Through the auto-reset, with the JAX reset's draws."""
    for task, edit, expect_done, expect_won in (
            ("ShadowHandDoorOpenOutward", "hinge", [True, False, True], [1.0, 0.0, 0.0]),
            ("ShadowHandPushBlock", "table", [True, False, True], [0.0, 0.0, 0.0])):
        tenv = make_env("dexhands_jax", {"task": task}, device="cpu")
        jenv = jma.make_manip({"task": task})
        keys = jax.random.split(jax.random.PRNGKey(4), 3)
        jreset, jstep = jax_fns(task)
        js, _ = jreset(keys)
        t = np.array(js.t)
        t[2] = jenv.episode_length - 1
        if edit == "hinge":
            hinge = np.array(js.hinge)
            hinge[0] = 0.5
            js = js._replace(hinge=jnp.asarray(hinge), t=jnp.asarray(t))
        else:
            pos = np.array(js.obj_pos)
            pos[0, 0] = (0.4, 0.0, -0.02)
            js = js._replace(obj_pos=jnp.asarray(pos), t=jnp.asarray(t))
        a = np.zeros((3, 2, 20), np.float32)
        jnext, jfinal = jstep(js, jnp.asarray(a))
        state = tma.ManipState(*(torch.from_numpy(np.array(x)) for x in js))
        ttr = auto_reset_step(tenv, state, torch.from_numpy(a),
                              _noise(tenv, _step_reset_keys(jax.random.PRNGKey(9), 3)))
        dones = ttr.final.dones[:, 0].numpy()
        np.testing.assert_array_equal(dones, np.asarray(jfinal.dones)[:, 0])
        np.testing.assert_array_equal(ttr.final.bad_transition.numpy(), jfinal.bad_transition)
        np.testing.assert_array_equal(ttr.final.metrics["won"].numpy(), jfinal.metrics["won"])
        assert dones.tolist() == expect_done, task
        assert ttr.final.bad_transition.tolist() == [False, False, True], task
        assert ttr.final.metrics["won"].tolist() == expect_won, task
        _close(ttr.final.rewards, jfinal.rewards)
        assert ttr.state.t.tolist() == [0, 1, 0]
