"""Port parity: the 3D Ant (``envs/mamujoco_jax/ant.py``) against the JAX env.

The kinematics (point positions, J = ∂p/∂q, the bias acceleration
∂(J q̇)/∂q · q̇), the mass matrix and one substep are held at rtol 1e-5 /
atol 1e-6 from the same states (the atol covers entries that cancel to
~0). A reset from replayed draws and 12 env steps of gentle actions run
free on each side at the planar tolerance (rtol 1e-4, atol 2e-4,
``tests/test_torch_planar.py``); dones and truncations are equal.

Longer free runs drift apart as float32 rounding is amplified through the
contacts, as Walker2d's do (ROADMAP.md, Queue C): over 20 steps of this run
the worst element reaches 1.27 of the tolerance at step 18 (1.65 at step 16
when the physics contracted through cuBLAS), where the JAX env's own
float32 run drifts from its float64 run by up to 0.68 of it; over the 12
steps held it reaches 0.70.

The JAX reference runs share one jitted substep (``_jax_substep``): the
free run's and the auto-reset's steps run op by op around it, where a
jitted step would compile all five substeps again for each.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harl_tpu.envs.mamujoco_jax import ant as jant
from harl_tpu_torch.envs import make_env
from harl_tpu_torch.envs.core import auto_reset_step
from harl_tpu_torch.envs.mamujoco_jax import ant as tant

from tests.torch_replay import _step_reset_keys, reset_noise, step_reset_noise

KIN_RTOL, KIN_ATOL = 1e-5, 1e-6
RTOL, ATOL = 1e-4, 2e-4
X = 8


def _share(a, b, rtol=RTOL, atol=ATOL):
    """The worst element's distance as a share of the tolerance."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / (atol + rtol * np.abs(b))).max())


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _envs(conf):
    args = {"scenario": "Ant-v2", "agent_conf": conf}
    return jant.make_ant(args), make_env("mamujoco_jax", args, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_substep():
    """The JAX Ant's substep, jitted once a file."""
    return jax.jit(jant.AntDynamics()._substep)


@dataclasses.dataclass(frozen=True)
class _SharedSubstep(jant.AntDynamics):
    """The JAX Ant's dynamics, its substep the one jitted ``_jax_substep``."""

    def _substep(self, q, qd, tau):
        return _jax_substep()(q, qd, tau)


@functools.lru_cache(maxsize=None)
def _jax_fns(conf):
    """The JAX env's jitted, vmapped reset and its vmapped step, whose five
    substeps go through one jitted substep, compiled once for every JAX
    reference run of this file; the rest of the step runs op by op."""
    jenv = dataclasses.replace(jant.make_ant({"scenario": "Ant-v2", "agent_conf": conf}),
                               dyn=_SharedSubstep())
    return jax.jit(jax.vmap(jenv.reset)), jax.vmap(lambda s, a: jenv.step(s, a, None))


def _port_state(js) -> tant.AntState:
    return tant.AntState(*(torch.from_numpy(np.array(x)) for x in js))


@pytest.mark.parametrize("conf,sizes", [("2x4", [4, 4]), ("4x2", [2, 2, 2, 2]),
                                        ("8x1", [1] * 8)])
def test_spaces_match_jax(conf, sizes):
    jenv, tenv = _envs(conf)
    assert isinstance(tenv, tant.AntMAMuJoCo) and tenv.n_agents == jenv.n_agents
    assert [sp.shape[0] for sp in tenv.action_space] == [sp.shape[0] for sp in
                                                          jenv.action_space] == sizes
    assert tenv.observation_space[0].shape == jenv.observation_space[0].shape
    assert tenv.share_observation_space[0].shape == jenv.share_observation_space[0].shape == (26,)
    assert tenv.episode_limit == jenv.episode_limit == 1000
    assert tenv.reset_noise_spec == (("uniform", 14), ("normal", 14))
    with pytest.raises(ValueError, match="exceeds"):
        tant.make_ant({"agent_conf": "3x3"}, torch.device("cpu"))


def _jax_kinematics(dyn):
    def one(q, qd):
        J = jax.jacfwd(dyn._points)(q)
        _, a_bias = jax.jvp(lambda qq: jax.jvp(dyn._points, (qq,), (qd,))[1], (q,), (qd,))
        M = jnp.einsum("p,pci,pcj->ij", dyn.masses, J, J)
        M = M + jnp.diag(jnp.concatenate([jnp.zeros(6), jnp.full((8,), jant.ARMATURE)]))
        return dyn._points(q), J, a_bias, M + 1e-8 * jnp.eye(14)

    return jax.jit(jax.vmap(one))


def _states(seed, n=16):
    """Reset-like states, some with a rotation vector below the 1e-4 blend,
    some turned far, some pressed into the ground (contacts, joint limits)."""
    rng = np.random.default_rng(seed)
    q = np.zeros((n, 14), np.float32)
    q[:, 2] = 0.6
    q += rng.uniform(-0.5, 0.5, (n, 14)).astype(np.float32)
    q[:4, 3:6] *= 1e-5
    q[4:6, 3:6] = rng.uniform(-2.0, 2.0, (2, 3))
    q[6:10, 2] = 0.1
    qd = rng.normal(0.0, 1.0, (n, 14)).astype(np.float32)
    return q, qd


def test_kinematics_and_substep_match_jax():
    dyn = jant.AntDynamics()
    tdyn = tant.AntDynamics(torch.device("cpu"))
    q, qd = _states(0)
    jp, jJ, jab, jM = _jax_kinematics(dyn)(q, qd)
    tp, tJ, tab = tdyn.kinematics(torch.from_numpy(q), torch.from_numpy(qd))
    assert tuple(tJ.shape) == (16, 43, 3, 14)
    for t, j in ((tp, jp), (tJ, jJ), (tab, jab), (tdyn.mass_matrix(tJ), jM)):
        _close(t, j, KIN_RTOL, KIN_ATOL)
    tau = np.random.default_rng(1).uniform(-1.0, 1.0, (16, 8)).astype(np.float32)
    jq, jqd, jn = jax.jit(jax.vmap(dyn._substep))(q, qd, tau)
    tq, tqd, tn = tdyn.substep(torch.from_numpy(q), torch.from_numpy(qd), torch.from_numpy(tau))
    for t, j in ((tq, jq), (tqd, jqd), (tn, jn)):
        _close(t, j, KIN_RTOL, KIN_ATOL)
    assert float(tn.min()) == 0.0 and float(tn.max()) > 100.0   # in the air, and in contact


def test_reset_and_free_steps_match_jax():
    """A reset from replayed draws, then 12 env steps of gentle actions
    (±0.3), each side on its own state: the ant drops onto its feet."""
    _, tenv = _envs("4x2")
    jreset, jstep = _jax_fns("4x2")
    keys = jax.random.split(jax.random.PRNGKey(1), X)
    js, jts = jreset(keys)
    ts, tts = tenv.reset(tuple(torch.from_numpy(np.array(x)) for x in reset_noise(keys, 14)))
    _close(ts.q, js.q, 1e-6, 1e-7)
    _close(tts.obs, jts.obs, 1e-5, 1e-5)
    rng = np.random.default_rng(0)
    worst = 0.0
    width = max(tenv._agent_sizes())
    for _ in range(12):
        a = rng.uniform(-0.3, 0.3, (X, tenv.n_agents, width)).astype(np.float32)
        js, jts = jstep(js, jnp.asarray(a))
        ts, tts = tenv.step(ts, torch.from_numpy(a))
        for t, j in ((ts.q, js.q), (ts.qd, js.qd), (tts.obs, jts.obs),
                     (tts.share_obs, jts.share_obs), (tts.rewards, jts.rewards)):
            worst = max(worst, _share(t, j))
        np.testing.assert_array_equal(tts.dones.numpy(), np.asarray(jts.dones))
        np.testing.assert_array_equal(tts.bad_transition.numpy(), np.asarray(jts.bad_transition))
    print(f"worst element over 12 free steps: {worst:.3f} of the tolerance")
    assert worst <= 1.0
    assert float(ts.q[:, 2].max()) < 0.7    # it fell onto its legs


def test_unhealthy_termination_and_auto_reset_match_jax():
    """A tipped torso (|rotation vector| past 1.9π), a sunk one (z below
    0.2, falling), healthy ones and ones at the episode limit, through the
    auto-reset (``envs/core.py``): dones where the torso failed and no
    truncation, truncations at the limit, and the ended envs reset with the
    JAX reset's draws of that step (core.py:49-54)."""
    _, tenv = _envs("4x2")
    jreset, jstep = _jax_fns("4x2")
    js, _ = jreset(jax.random.split(jax.random.PRNGKey(3), X))
    q, qd = np.array(js.q), np.array(js.qd)
    q[0, 3:6] = [0.0, 0.0, 1.95 * np.pi]       # tipped
    q[1, 2], qd[1, 2] = 0.05, -3.0               # sunk
    t = np.array([0, 0, 0, 0, 999, 999, 999, 999], np.int32)
    js = js._replace(q=jnp.asarray(q), qd=jnp.asarray(qd), t=jnp.asarray(t))
    a = np.random.default_rng(2).uniform(-0.3, 0.3, (X, 4, 2)).astype(np.float32)
    k_env = jax.random.PRNGKey(9)
    jnext, jfinal = jstep(js, jnp.asarray(a))
    jfresh, jfresh_ts = jreset(_step_reset_keys(k_env, X))
    u, n = step_reset_noise(k_env, X, 14)
    ttr = auto_reset_step(tenv, _port_state(js), torch.from_numpy(a),
                          (torch.from_numpy(np.array(u)), torch.from_numpy(np.array(n))))
    dones = ttr.final.dones[:, 0].numpy()
    bad = ttr.final.bad_transition.numpy()
    np.testing.assert_array_equal(dones, np.asarray(jfinal.dones)[:, 0])
    np.testing.assert_array_equal(bad, np.asarray(jfinal.bad_transition))
    assert dones.tolist() == [True, True, False, False, True, True, True, True]
    assert bad.tolist() == [False, False, False, False, True, True, True, True]
    _close(ttr.final.rewards, jfinal.rewards)
    ended = dones[:, None]
    for t_, j_next, j_fresh in zip(ttr.state, jnext, jfresh):
        expect = np.where(ended if np.ndim(j_next) == 2 else dones, j_fresh, j_next)
        _close(t_, expect)
    _close(ttr.ts.obs, np.where(ended[:, :, None], jfresh_ts.obs, jfinal.obs))
    assert ttr.state.t.tolist() == [0, 0, 1, 1, 0, 0, 0, 0]


def test_unported_mamujoco_scenarios_name_their_item():
    # every mamujoco_jax scenario is ported (manyagent_ant, manyagent_swimmer,
    # coupled_half_cheetah and Reacher-v2 since, in their own test files);
    # the host MAMuJoCo env (ported since, tests/test_torch_host_*.py) runs
    # gymnasium's tasks, which have none of the first three, and refuses
    # Reacher's 2 joints for six agents, as the JAX package's does
    import gymnasium

    for scenario, n_agents in (("manyagent_ant", 2), ("manyagent_swimmer", 4),
                               ("coupled_half_cheetah", 2), ("Reacher-v2", 2)):
        assert make_env("mamujoco_jax", {"scenario": scenario}, device="cpu").n_agents == n_agents
        if scenario == "Reacher-v2":
            with pytest.raises(ValueError, match="exceeds action dim 2"):
                make_env("mamujoco", {"scenario": scenario}, device="cpu")
            assert make_env("mamujoco", {"scenario": scenario, "agent_conf": "2x1"},
                            device="cpu").n_agents == 2
        else:
            with pytest.raises(gymnasium.error.NameNotFound):
                make_env("mamujoco", {"scenario": scenario}, device="cpu")
