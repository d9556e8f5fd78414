"""Port parity: the 3D Humanoid and HumanoidStandup
(``envs/mamujoco_jax/humanoid.py``) against the JAX env.

The kinematics (point positions, J = ∂p/∂q, the bias acceleration
∂(J q̇)/∂q · q̇, the contact Jacobian) and the mass matrix are held at rtol
1e-5 / atol 1e-6 from the same random states, some with a root rotation
below the 1e-4 blend, some lying in the ground (the atol covers entries
that cancel to ~0).

One substep is held against the JAX substep run in float64
(``jax.enable_x64``): q′ and the normal forces at rtol 1e-5 / atol 1e-6,
q̇′ at rtol 1e-5 / atol 1e-4. The stiff contacts (20,000 N/m at dt 0.003)
and the light arms make the 23×23 system ill-conditioned: from these states
the JAX env's own float32 substep lands up to 3.9 of that q̇′ tolerance from
float64 (and 103 of rtol 1e-5 / atol 1e-6), while the port, which assembles
and solves the system in float64, lands within 0.16 of it; the test asserts
that the port is the closer of the two (ROADMAP.md, Queue C).

A reset from replayed draws and a few env steps of gentle actions run free
on each side at the planar tolerance (rtol 1e-4, atol 2e-4,
``tests/test_torch_planar.py``), with the worst element's share of the
tolerance printed; dones and truncations are equal. The standup
reset lies far from the blend, pitched −π/2.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harl_tpu.envs.mamujoco_jax import humanoid as jh
from harl_tpu_torch.envs import make_env
from harl_tpu_torch.envs.core import auto_reset_step
from harl_tpu_torch.envs.mamujoco_jax import humanoid as th

from tests import torch_replay as replay
from tests.torch_replay import _step_reset_keys

KIN_RTOL, KIN_ATOL = 1e-5, 1e-6
QD_ATOL = 1e-4
RTOL, ATOL = 1e-4, 2e-4
X = 6
CPU = torch.device("cpu")


def _share(a, b, rtol=RTOL, atol=ATOL):
    """The worst element's distance as a share of the tolerance."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / (atol + rtol * np.abs(b))).max())


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _args(scenario="Humanoid-v2", **kw):
    return {"scenario": scenario, "agent_conf": "17x1", **kw}


@functools.lru_cache(maxsize=None)
def _jax_fns(items):
    """The JAX env's jitted, vmapped reset and step (compiled once a file)."""
    jenv = jh.make_humanoid(dict(items))
    return (jax.jit(jax.vmap(jenv.reset)),
            jax.jit(jax.vmap(lambda s, a: jenv.step(s, a, None))))


def humanoid_reset_noise(keys):
    return tuple(torch.from_numpy(np.array(x)) for x in replay.humanoid_reset_noise(keys))


def _port_state(js) -> th.HumanoidState:
    return th.HumanoidState(*(torch.from_numpy(np.array(x)) for x in js))


@pytest.mark.parametrize("scenario,conf,sizes,obsk", [
    ("Humanoid-v2", "17x1", [1] * 17, None),
    ("Humanoid-v2", "9|8", [9, 8], None),
    ("Humanoid-v2", "9|8", [9, 8], 0),
    ("Humanoid-v2", "5|12", [5, 12], None),
    ("HumanoidStandup-v2", "17x1", [1] * 17, None)])
def test_spaces_match_jax(scenario, conf, sizes, obsk):
    args = {"scenario": scenario, "agent_conf": conf, "agent_obsk": obsk}
    jenv, tenv = jh.make_humanoid(args), make_env("mamujoco_jax", args, device="cpu")
    assert isinstance(tenv, th.HumanoidMAMuJoCo) and tenv.n_agents == jenv.n_agents
    assert tenv.agent_joints == jenv.agent_joints and tenv.standup == jenv.standup
    assert [sp.shape[0] for sp in tenv.action_space] == [sp.shape[0] for sp in
                                                          jenv.action_space] == sizes
    assert all(sp.low[0] == -0.4 and sp.high[0] == 0.4 for sp in tenv.action_space)
    assert [sp.shape for sp in tenv.observation_space] == [sp.shape for sp in
                                                           jenv.observation_space]
    assert tenv.share_observation_space[0].shape == jenv.share_observation_space[0].shape == (44,)
    assert tenv.obs_dim == jenv.obs_dim and tenv.episode_limit == jenv.episode_limit == 1000
    assert tenv.reset_noise_spec == (("uniform", 23), ("uniform", 23))
    with pytest.raises(ValueError, match="partition"):
        th.make_humanoid({"agent_conf": "9|9"}, CPU)


def test_point_masses_match_jax():
    np.testing.assert_array_equal(th.HumanoidDynamics(CPU).masses.numpy(),
                                  np.asarray(jh.PT_MASS))
    assert abs(th.TOTAL_MASS - jh.TOTAL_MASS) <= 1e-6 * jh.TOTAL_MASS
    np.testing.assert_array_equal(th.HumanoidDynamics(CPU).q0.numpy(), np.asarray(jh.Q0))


def _states(seed, n=12):
    """Random states: standing, some with a rotation vector below the 1e-4
    blend, some turned far, some lying in the ground (contacts), some past
    the joint limits."""
    rng = np.random.default_rng(seed)
    q = np.zeros((n, jh.DOF), np.float32)
    q[:, 2] = 1.3
    q += rng.uniform(-0.6, 0.6, (n, jh.DOF)).astype(np.float32)
    q[:3, 3:6] *= 1e-5
    q[3:5, 3:6] = rng.uniform(-2.0, 2.0, (2, 3))
    q[5:8, 2] = 0.1
    q[8:10, 4] = -0.5 * np.pi
    q[8:10, 2] = 0.2
    q[10:, 6:] *= 4.0
    qd = rng.normal(0.0, 1.0, (n, jh.DOF)).astype(np.float32)
    return q, qd


@functools.lru_cache(maxsize=None)
def _jax_kinematics():
    def one(q, qd):
        J = jax.jacfwd(jh._points)(q)
        _, a_bias = jax.jvp(lambda qq: jax.jvp(jh._points, (qq,), (qd,))[1], (q,), (qd,))
        M = jnp.einsum("p,pci,pcj->ij", jh.PT_MASS, J, J)
        M = M + jnp.diag(jnp.concatenate([jnp.zeros(6), jh.ARMATURES])) + 1e-6 * jnp.eye(jh.DOF)
        return jh._points(q), J, a_bias, M, jh._contacts(q), jax.jacfwd(jh._contacts)(q)

    return jax.jit(jax.vmap(one))


def test_kinematics_match_jax():
    dyn = th.HumanoidDynamics(CPU)
    q, qd = _states(0)
    jp, jJ, jab, jM, jc, jJc = _jax_kinematics()(q, qd)
    tp, tJ, tab = dyn.kinematics(torch.from_numpy(q), torch.from_numpy(qd))
    nm = dyn.n_mass
    assert tuple(tJ.shape) == (12, 54, 3, 23) and nm == 41
    for t, j in ((tp[:, :nm], jp), (tJ[:, :nm], jJ), (tab[:, :nm], jab),
                 (dyn.mass_matrix(tJ), jM), (tp[:, nm:], jc), (tJ[:, nm:], jJc),
                 (dyn.positions(torch.from_numpy(q)), jp)):
        _close(t, j, KIN_RTOL, KIN_ATOL)


def test_substep_matches_jax_in_float64():
    dyn = th.HumanoidDynamics(CPU)
    q, qd = _states(1)
    tau = np.random.default_rng(1).uniform(-0.4, 0.4, (12, 17)).astype(np.float32)
    _, jqd32, _ = jax.jit(jax.vmap(jh._substep))(q, qd, tau)
    with jax.enable_x64(True):
        jq, jqd, jn = (np.asarray(x) for x in jax.jit(jax.vmap(jh._substep))(
            *(x.astype(np.float64) for x in (q, qd, tau))))
    tq, tqd, tn, _ = dyn.substep(torch.from_numpy(q), torch.from_numpy(qd), torch.from_numpy(tau))
    _close(tq, jq, KIN_RTOL, KIN_ATOL)
    _close(tn, jn, KIN_RTOL, KIN_ATOL)
    port, jax32 = _share(tqd, jqd, KIN_RTOL, QD_ATOL), _share(jqd32, jqd, KIN_RTOL, QD_ATOL)
    print(f"q' from float64: the port {port:.3f}, JAX's float32 substep {jax32:.3f} of the "
          f"tolerance")
    assert port <= 1.0 and port < jax32
    assert float(tn.min()) == 0.0 and float(tn.max()) > 1000.0   # in the air, and in contact


@pytest.mark.parametrize("scenario,steps", [("Humanoid-v2", 12), ("HumanoidStandup-v2", 6)])
def test_reset_and_free_steps_match_jax(scenario, steps):
    """A reset from replayed draws, then env steps of gentle actions (±0.1),
    each side on its own state; the standup reward is ~q_z/dt lying down."""
    args = _args(scenario, obs_standardize=False)
    tenv = make_env("mamujoco_jax", args, device="cpu")
    jreset, jstep = _jax_fns(tuple(sorted(args.items())))
    keys = jax.random.split(jax.random.PRNGKey(1), X)
    js, jts = jreset(keys)
    ts, tts = tenv.reset(humanoid_reset_noise(keys))
    _close(ts.q, js.q, 1e-6, 1e-7)
    _close(tts.obs, jts.obs, 1e-6, 1e-7)
    rng = np.random.default_rng(0)
    worst = 0.0
    for _ in range(steps):
        a = rng.uniform(-0.1, 0.1, (X, 17, 1)).astype(np.float32)
        js, jts = jstep(js, jnp.asarray(a))
        ts, tts = tenv.step(ts, torch.from_numpy(a))
        for t, j in ((ts.q, js.q), (ts.qd, js.qd), (tts.obs, jts.obs),
                     (tts.share_obs, jts.share_obs), (tts.rewards, jts.rewards)):
            worst = max(worst, _share(t, j))
        np.testing.assert_array_equal(tts.dones.numpy(), np.asarray(jts.dones))
        np.testing.assert_array_equal(tts.bad_transition.numpy(), np.asarray(jts.bad_transition))
    print(f"{scenario}: worst element over {steps} free steps: {worst:.3f} of the tolerance")
    assert worst <= 1.0
    if scenario.startswith("HumanoidStandup"):
        assert not tts.dones.any()
        r = tts.rewards[:, 0, 0].numpy()
        np.testing.assert_allclose(r, ts.q[:, 2].numpy() / th.DT, rtol=0.05)


def test_unhealthy_termination_and_auto_reset_match_jax():
    """A torso lifted past the 2.0 height bound, a tipped one (|rotation vector| past
    1.9π), healthy ones and ones at the episode limit, through the
    auto-reset: dones where the torso failed and no truncation, truncations
    at the limit, the ended envs reset with the JAX reset's draws."""
    args = _args(obs_standardize=False)
    tenv = make_env("mamujoco_jax", args, device="cpu")
    jreset, jstep = _jax_fns(tuple(sorted(args.items())))
    js, _ = jreset(jax.random.split(jax.random.PRNGKey(3), X))
    q, qd = np.array(js.q), np.array(js.qd)
    q[0, 2] = 2.5                                 # too high
    q[1, 3:6] = [0.0, 0.0, 1.95 * np.pi]          # tipped
    t = np.array([0, 0, 0, 999, 999, 999], np.int32)
    js = js._replace(q=jnp.asarray(q), qd=jnp.asarray(qd), t=jnp.asarray(t))
    a = np.random.default_rng(2).uniform(-0.1, 0.1, (X, 17, 1)).astype(np.float32)
    k_env = jax.random.PRNGKey(9)
    jnext, jfinal = jstep(js, jnp.asarray(a))
    jfresh, jfresh_ts = jreset(_step_reset_keys(k_env, X))
    ttr = auto_reset_step(tenv, _port_state(js), torch.from_numpy(a),
                          humanoid_reset_noise(_step_reset_keys(k_env, X)))
    dones = ttr.final.dones[:, 0].numpy()
    bad = ttr.final.bad_transition.numpy()
    np.testing.assert_array_equal(dones, np.asarray(jfinal.dones)[:, 0])
    np.testing.assert_array_equal(bad, np.asarray(jfinal.bad_transition))
    assert dones.tolist() == [True, True, False, True, True, True]
    assert bad.tolist() == [False, False, False, True, True, True]
    _close(ttr.final.rewards, jfinal.rewards)
    ended = dones[:, None]
    for t_, j_next, j_fresh in zip(ttr.state, jnext, jfresh):
        expect = np.where(ended if np.ndim(j_next) == 2 else dones, j_fresh, j_next)
        _close(t_, expect)
    _close(ttr.ts.obs, np.where(ended[:, :, None], jfresh_ts.obs, jfinal.obs))
    assert ttr.state.t.tolist() == [0, 0, 1, 0, 0, 0]


@pytest.mark.parametrize("kw", [dict(agent_conf="9|8", agent_obsk=0),
                                dict(agent_conf="17x1", agent_obsk=0),
                                dict(obs_standardize=True), dict(obs_standardize=False)])
def test_observations_match_jax(kw):
    """The local observations (11 features a joint, padded to the widest
    agent) and the standardised or scaled full-state ones, from the same
    random states."""
    args = {**_args(), **kw}
    jenv, tenv = jh.make_humanoid(args), make_env("mamujoco_jax", args, device="cpu")
    q, qd = _states(2)
    js = jh.HumanoidState(q=jnp.asarray(q), qd=jnp.asarray(qd), t=jnp.zeros(12, jnp.int32))
    z = jnp.zeros(12)
    jts = jax.jit(jax.vmap(lambda s, r, d: jenv._timestep(s, r, d, d)))(js, z, z.astype(bool))
    no = torch.zeros(12, dtype=torch.bool)
    tts = tenv._timestep(_port_state(js), torch.zeros(12), no, no)
    assert tts.obs.shape == jts.obs.shape
    _close(tts.obs, jts.obs, KIN_RTOL, 1e-5)
    _close(tts.share_obs, jts.share_obs, 0, 0)
