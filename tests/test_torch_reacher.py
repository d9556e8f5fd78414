"""Port parity: Reacher-v2 2x1 (``envs/mamujoco_jax/reacher.py``) against
the JAX env.

The written-out J and bias acceleration are held against ``jax.jacfwd``
and the nested ``jax.jvp``, and one substep (joint 1 inside and past its
limit) against the JAX substep, at rtol 1e-5 / atol 1e-6. A reset from
replayed draws (the polar target included) and free env steps of random
actions run at the planar tolerance (rtol 1e-4 / atol 2e-4), through the
truncation at ``episode_limit``; the reward reads the fingertip before the
physics step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from harl_tpu.envs.mamujoco_jax import reacher as jre
from harl_tpu_torch.envs import make_env
from harl_tpu_torch.envs.mamujoco_jax import reacher as tre

KIN_RTOL, KIN_ATOL = 1e-5, 1e-6
RTOL, ATOL = 1e-4, 2e-4
X = 16


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _states(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-3.5, 3.5, (X, 2)).astype(np.float32)     # some past joint 1's limit
    qd = rng.normal(0.0, 3.0, (X, 2)).astype(np.float32)
    tau = rng.uniform(-1.0, 1.0, (X, 2)).astype(np.float32)
    return q, qd, tau


def test_spaces_kinematics_and_substep_match_jax():
    jenv = jre.make_reacher({})
    tenv = make_env("mamujoco_jax", {"scenario": "Reacher-v2", "agent_conf": "2x1"},
                    device="cpu")
    assert isinstance(tenv, tre.ReacherMAMuJoCo)
    assert (tenv.obs_dim, tenv.state_dim, tenv.episode_limit) == (
        jenv.obs_dim, jenv.state_dim, jenv.episode_limit)
    q, qd, tau = _states()
    assert (np.abs(q[:, 1]) > 3.0).any()
    jJ = jax.vmap(jax.jacfwd(jre._points))(q)
    jb = jax.vmap(lambda a, b: jax.jvp(lambda qq: jax.jvp(jre._points, (qq,), (b,))[1],
                                       (a,), (b,))[1])(q, qd)
    tJ, tb = tenv.kinematics(torch.from_numpy(q), torch.from_numpy(qd))
    _close(tenv.points(torch.from_numpy(q)), jax.vmap(jre._points)(q), KIN_RTOL, KIN_ATOL)
    _close(tJ, jJ, KIN_RTOL, KIN_ATOL)
    _close(tb, jb, KIN_RTOL, KIN_ATOL)
    jq, jqd = jax.jit(jax.vmap(jenv._substep))(q, qd, tau)
    tq, tqd = tenv.substep(*(torch.from_numpy(x) for x in (q, qd, tau)))
    _close(tq, jq, KIN_RTOL, KIN_ATOL)
    _close(tqd, jqd, KIN_RTOL, KIN_ATOL)


def reacher_reset_noise(keys):
    """The reset's four uniform draws (reacher.py:107-112)."""
    def one(k):
        k1, k2, k3, k4 = jax.random.split(k, 4)
        u = jax.random.uniform
        return u(k1, (2,)), u(k2, (2,)), u(k3, ()).reshape(1), u(k4, ()).reshape(1)

    return tuple(torch.from_numpy(np.array(x)) for x in jax.vmap(one)(keys))


def test_reset_and_free_steps_match_jax():
    jenv = jre.make_reacher({"episode_limit": 6})
    tenv = make_env("mamujoco_jax", {"scenario": "Reacher-v2", "episode_limit": 6},
                    device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(2), X)
    js, jts = jax.vmap(jenv.reset)(keys)
    ts, tts = tenv.reset(reacher_reset_noise(keys))
    for t, j in zip(ts[:3], js[:3]):
        _close(t, j, 1e-6, 1e-7)
    assert float(ts.target.norm(dim=1).max()) < 0.2
    _close(tts.obs, jts.obs, 1e-5, 1e-5)
    jstep = jax.jit(jax.vmap(lambda s, a: jenv.step(s, a, None)))
    rng = np.random.default_rng(0)
    for step in range(8):
        a = rng.uniform(-1.0, 1.0, (X, 2, 1)).astype(np.float32)
        js, jts = jstep(js, jnp.asarray(a))
        ts, tts = tenv.step(ts, torch.from_numpy(a))
        for t, j in ((ts.q, js.q), (ts.qd, js.qd), (tts.obs, jts.obs),
                     (tts.share_obs, jts.share_obs), (tts.rewards, jts.rewards)):
            _close(t, j)
        np.testing.assert_array_equal(tts.dones.numpy(), np.asarray(jts.dones))
        np.testing.assert_array_equal(tts.bad_transition.numpy(), np.asarray(jts.bad_transition))
        assert bool(tts.bad_transition.all()) == (step + 1 >= 6)
