"""Port parity: planar HalfCheetah-6x1, Walker2d and Hopper, and the
auto-reset env core.

The JAX env is vmapped over a small batch; the port steps the same batch
as one tensor. Both start from the same state and take the same actions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harl_tpu.envs import core as jcore
from harl_tpu.envs.mamujoco_jax.planar import PlanarState as JState
from harl_tpu.envs.mamujoco_jax.planar import make_planar as jmake
from harl_tpu_torch.envs import core as tcore
from harl_tpu_torch.envs import make_env
from harl_tpu_torch.envs.mamujoco_jax.planar import PlanarState, gauss_solve, make_planar

from tests.torch_replay import reset_noise, step_reset_noise

X, STEPS, LIMIT = 6, 25, 25
# float32 physics run free for 25 env steps (125 implicit-Euler substeps):
# the two sides round in another order and the differences grow, up to
# ~5e-5 in qd (|qd| up to ~10) at the last step.
RTOL, ATOL = 1e-4, 2e-4


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_free_run_matches_jax():
    """25 steps from one state with the same actions: q, qd, obs, share_obs,
    reward, done and bad stay equal; contacts occur and the last step
    truncates."""
    rng = np.random.default_rng(0)
    jenv = jmake({"episode_limit": LIMIT})
    tenv = make_planar({"episode_limit": LIMIT}, torch.device("cpu"))
    q = rng.uniform(-0.1, 0.1, (X, 9)).astype(np.float32)
    qd = (0.5 * rng.normal(size=(X, 9))).astype(np.float32)
    t = np.zeros(X, np.int32)
    jstate = JState(jnp.asarray(q), jnp.asarray(qd), jnp.asarray(t))
    tstate = PlanarState(_t(q), _t(qd), _t(t))
    step = jax.jit(jax.vmap(lambda s, a: jenv.step(s, a, None)))
    contact_steps = 0
    for k in range(STEPS):
        a = rng.uniform(-1, 1, (X, 6, 1)).astype(np.float32)
        jstate, jts = step(jstate, jnp.asarray(a))
        tstate, tts = tenv.step(tstate, _t(a))
        _close(tstate.q, jstate.q)
        _close(tstate.qd, jstate.qd)
        np.testing.assert_array_equal(tstate.t.numpy(), np.asarray(jstate.t))
        _close(tts.obs, jts.obs)
        _close(tts.share_obs, jts.share_obs)
        _close(tts.rewards, jts.rewards)
        np.testing.assert_array_equal(tts.dones.numpy(), np.asarray(jts.dones))
        np.testing.assert_array_equal(tts.bad_transition.numpy(), np.asarray(jts.bad_transition))
        _, _, cpos, _ = tenv.dyn.kin_analytic(tstate.q, tstate.qd)
        contact_steps += int(bool((cpos[..., 1] < tenv.dyn.crad).any()))
    assert contact_steps > STEPS // 2
    assert bool(tts.bad_transition.all()) and bool(tts.dones.all())


def test_obs_standardisation_is_population_std():
    """Per-observation standardisation uses ddof=0, like jnp.std: each
    agent's obs row has mean 0 and population std ~1."""
    tenv = make_planar({}, torch.device("cpu"))
    rng = np.random.default_rng(1)
    u, n = _t(rng.uniform(size=(3, 9)).astype(np.float32)), _t(
        rng.normal(size=(3, 9)).astype(np.float32))
    _, ts = tenv.reset((u, n))
    obs = ts.obs.numpy()
    _close(obs.std(axis=-1, ddof=0), np.ones((3, 6)), 1e-5, 1e-5)
    assert np.abs(obs.std(axis=-1, ddof=1) - 1.0).min() > 1e-2


def test_reset_matches_jax_draws():
    """The same keys give the same reset state: uniform qpos noise and
    Normal qvel noise for the cheetah (planar.py:176-178, :654-655)."""
    jenv = jmake({})
    tenv = make_planar({}, torch.device("cpu"))
    keys = jax.random.split(jax.random.PRNGKey(3), X)
    jstate, jts = jax.vmap(jenv.reset)(keys)
    u, n = reset_noise(keys, 9)
    tstate, tts = tenv.reset((_t(u), _t(n)))
    _close(tstate.q, jstate.q, 1e-6, 1e-7)
    _close(tstate.qd, jstate.qd, 1e-6, 1e-7)
    _close(tts.obs, jts.obs, 1e-5, 1e-5)
    # Normal, not uniform: the cheetah's qvel noise exceeds the 0.1 bound
    assert np.abs(u).max() < 1.0 and float(tstate.qd.abs().max()) > 0.1


def test_auto_reset_step_matches_jax():
    """A truncating step returns the fresh episode's obs and state, and the
    finishing step's reward, done and bad flag (core.py:49-78)."""
    jenv = jmake({"episode_limit": 2})
    tenv = make_env("mamujoco_jax", {"scenario": "HalfCheetah-v2", "agent_conf": "6x1",
                                     "episode_limit": 2}, device="cpu")
    rng = np.random.default_rng(4)
    jstate, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), X))
    # half the envs are one step from their limit
    jstate = jstate._replace(t=jnp.asarray(np.array([0, 1] * (X // 2), np.int32)))
    tstate = PlanarState(_t(jstate.q), _t(jstate.qd), _t(jstate.t))
    a = rng.uniform(-1, 1, (X, 6, 1)).astype(np.float32)
    k_env = jax.random.PRNGKey(9)
    jtr = jcore.VecEnv(jenv, X).step(jstate, jnp.asarray(a), k_env)
    u, n = step_reset_noise(k_env, X, 9)
    ttr = tcore.auto_reset_step(tenv, tstate, _t(a), (_t(u), _t(n)))
    for name in ("q", "qd"):
        _close(getattr(ttr.state, name), getattr(jtr.state, name), 1e-5, 1e-5)
    np.testing.assert_array_equal(ttr.state.t.numpy(), np.asarray(jtr.state.t))
    for name in ("obs", "share_obs", "rewards"):
        _close(getattr(ttr.ts, name), getattr(jtr.ts, name), 1e-5, 1e-5)
        _close(getattr(ttr.final, name), getattr(jtr.final, name), 1e-5, 1e-5)
    np.testing.assert_array_equal(ttr.ts.dones.numpy(), np.asarray(jtr.ts.dones))
    np.testing.assert_array_equal(ttr.ts.bad_transition.numpy(),
                                  np.asarray(jtr.ts.bad_transition))
    assert ttr.ts.dones[:, 0].tolist() == [False, True] * (X // 2)


def test_gauss_solve_matches_linalg():
    rng = np.random.default_rng(5)
    m = rng.normal(size=(4, 9, 9))
    A = m @ m.transpose(0, 2, 1) + 9 * np.eye(9)
    b = rng.normal(size=(4, 9))
    x = gauss_solve(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    _close(x, np.linalg.solve(A, b[..., None])[..., 0], 1e-10, 1e-12)


def test_unported_envs_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_env("football_jax", {}, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_env("mamujoco_jax", {"scenario": "manyagent_ant"}, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_env("mamujoco_jax", {"scenario": "manyagent_swimmer"}, device="cpu")
    # ported since: Walker2d and Hopper, the 3D Ant (test_torch_ant.py) and
    # the Humanoid (test_torch_humanoid.py), with their JAX defaults
    assert make_env("mamujoco_jax", {"scenario": "Humanoid-v2"}, device="cpu").n_agents == 17
    assert make_env("mamujoco_jax", {"scenario": "Walker2d-v2"}, device="cpu").n_agents == 2
    assert make_env("mamujoco_jax", {"scenario": "Hopper-v2"}, device="cpu").n_agents == 3
    assert make_env("mamujoco_jax", {"scenario": "Ant-v2"}, device="cpu").n_agents == 4


# ------------------------------------------------------ Walker2d and Hopper
# (scenario, agent_conf, dof, pitch that starts envs falling, its rate)
FALLERS = [("Walker2d-v2", "2x3", 9, 0.97, 4.0), ("Hopper-v2", "3x1", 6, 0.19, 2.0)]


@pytest.mark.parametrize("scenario,conf,dof,pitch,rate", FALLERS,
                         ids=[f[0] for f in FALLERS])
def test_termination_and_auto_reset_match_jax(scenario, conf, dof, pitch, rate):
    """From the JAX reset (uniform qpos and qvel noise, replayed), half the
    envs are tipped over: they terminate unhealthy (``dones`` without
    ``bad_transition``) and auto-reset, the others run to the truncation at
    the limit (both flags). The state, obs, reward and flags stay equal on
    every step, the healthy reward included. Walker2d's stiffer contacts
    (20000 N/m at dt 0.002) round worse than the cheetah's: one env step from
    a random state leaves the JAX env itself ~3e-3 from a float64 step, so
    the run is kept to 12 steps at the cheetah's tolerances."""
    limit, steps = 8, 12
    env_args = {"scenario": scenario, "agent_conf": conf, "episode_limit": limit}
    jenv = jmake(env_args)
    tenv = make_env("mamujoco_jax", env_args, device="cpu")
    assert tenv.reset_noise_spec == (("uniform", dof), ("uniform", dof))
    keys = jax.random.split(jax.random.PRNGKey(11), X)
    jstate, jts = jax.vmap(jenv.reset)(keys)
    tstate, tts = tenv.reset(tuple(_t(x) for x in reset_noise(keys, dof, qvel_normal=False)))
    _close(tstate.q, jstate.q, 1e-6, 1e-7)
    _close(tstate.qd, jstate.qd, 1e-6, 1e-7)
    _close(tts.obs, jts.obs, 1e-5, 1e-5)
    assert float(tstate.qd.abs().max()) <= 5e-3      # uniform, not normal
    tip = np.zeros((X, dof), np.float32)
    tip[::2, 2] = pitch
    q = jstate.q + tip
    qd = jstate.qd + np.where(tip != 0, rate, 0.0).astype(np.float32)
    jstate = jstate._replace(q=q, qd=qd)
    tstate = PlanarState(_t(q), _t(qd), tstate.t)
    rng = np.random.default_rng(7)
    n_agents, width = tenv.n_agents, max(sp.dim for sp in tenv.action_space)
    vec = jcore.VecEnv(jenv, X)
    terminated = truncated = 0
    for k in range(steps):
        a = rng.uniform(-0.3, 0.3, (X, n_agents, width)).astype(np.float32)
        k_env = jax.random.fold_in(jax.random.PRNGKey(5), k)
        jtr = vec.step(jstate, jnp.asarray(a), k_env)
        ttr = tcore.auto_reset_step(
            tenv, tstate, _t(a), tuple(_t(x) for x in step_reset_noise(k_env, X, dof, False)))
        for name in ("q", "qd"):
            _close(getattr(ttr.state, name), getattr(jtr.state, name))
        np.testing.assert_array_equal(ttr.state.t.numpy(), np.asarray(jtr.state.t))
        for name in ("obs", "share_obs", "rewards"):
            _close(getattr(ttr.ts, name), getattr(jtr.ts, name))
            _close(getattr(ttr.final, name), getattr(jtr.final, name))
        dones, bad = ttr.ts.dones.numpy(), ttr.ts.bad_transition.numpy()
        np.testing.assert_array_equal(dones, np.asarray(jtr.ts.dones))
        np.testing.assert_array_equal(bad, np.asarray(jtr.ts.bad_transition))
        terminated += int((dones[:, 0] & ~bad).sum())
        truncated += int(bad.sum())
        jstate, tstate = jtr.state, ttr.state
    assert terminated >= X // 2 and truncated >= 1, (terminated, truncated)


@pytest.mark.parametrize("scenario", ["Walker2d-v2", "Hopper-v2"])
def test_is_healthy_and_state_clip_match_jax(scenario):
    """Height, pitch and (hopper) state bounds on states near each edge, and
    the state vector's qvel clip to ±10 (planar.py:701-705)."""
    jenv = jmake({"scenario": scenario})
    tenv = make_env("mamujoco_jax", {"scenario": scenario}, device="cpu")
    dof = tenv.spec.dof
    rng = np.random.default_rng(2)
    q = np.tile(np.array([0.0, 1.25] + [0.0] * (dof - 2), np.float32), (64, 1))
    q[:, 1] += rng.uniform(-0.6, 0.9, 64).astype(np.float32)
    q[:, 2] = rng.uniform(-1.2, 1.2, 64).astype(np.float32)
    q[:, 3:] = rng.uniform(-150, 150, (64, dof - 3)).astype(np.float32) * (rng.uniform(
        size=(64, 1)) < 0.2)
    qd = rng.uniform(-120, 120, (64, dof)).astype(np.float32) * (rng.uniform(size=(64, 1)) < 0.3)
    want = np.asarray(jax.vmap(jenv._is_healthy)(jnp.asarray(q), jnp.asarray(qd)))
    got = tenv._is_healthy(_t(q), _t(qd)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < 64
    t = np.zeros(64, np.int32)
    jts = jax.vmap(jenv._timestep)(JState(jnp.asarray(q), jnp.asarray(qd), jnp.asarray(t)),
                                   jnp.zeros(64), jnp.zeros(64, bool), jnp.zeros(64, bool))
    tts = tenv._timestep(PlanarState(_t(q), _t(qd), _t(t)), torch.zeros(64),
                         torch.zeros(64, dtype=torch.bool), torch.zeros(64, dtype=torch.bool))
    _close(tts.share_obs, jts.share_obs, 1e-6, 1e-6)
    _close(tts.obs, jts.obs, 1e-5, 1e-5)
    assert float(tts.share_obs[:, dof - 1:].abs().max()) == 10.0 < np.abs(qd).max()
