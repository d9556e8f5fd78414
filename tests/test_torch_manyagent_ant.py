"""Port parity: the many-agent ant (``envs/mamujoco_jax/manyagent_ant.py``)
against the JAX env.

Point positions, J = ∂p/∂q, the bias acceleration and the contact points
of the port's ``AntDynamics`` on the ``manyant_body`` tables are held
against ``jax.jacfwd`` and the nested ``jax.jvp`` of the JAX env's
``_points`` and ``_contacts`` at rtol 1e-5 / atol 1e-5 (positions up to 6 m
from the root, ~1e-6 apart). One substep is held against the JAX substep
run in float64 at rtol 1e-5 / atol 1e-6: the JAX env's own float32 solve of
the 30×30 system (2x3) lands ~1.2 of that tolerance from it in q̇′, the port,
which solves in float64, ~0.8 (0.77; 0.71 when its sums ran through
cuBLAS); the test asserts the port is the closer. A
reset from replayed draws and free env steps of gentle actions run at the
planar tolerance (rtol 1e-4 / atol 2e-4); over those 8 steps both runs stay
within 0.06 (the port) and 0.25 (the JAX env) of it from the JAX env run in
float64. Dones and truncations are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harl_tpu.envs.mamujoco_jax import manyagent_ant as jma
from harl_tpu_torch.envs import make_env
from harl_tpu_torch.envs.mamujoco_jax import manyagent_ant as tma

from tests.torch_replay import reset_noise

KIN_RTOL, KIN_ATOL = 1e-5, 1e-6
RTOL, ATOL = 1e-4, 2e-4
X = 8


def _share(a, b, rtol=RTOL, atol=ATOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / (atol + rtol * np.abs(b))).max())


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _states(dof, seed=0, n=12):
    """Reset-like states, some with a rotation vector below the 1e-4 blend,
    some pressed into the ground (contacts, joint limits)."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-0.5, 0.5, (n, dof)).astype(np.float32)
    q[:, 2] += 0.6
    q[:3, 3:6] *= 1e-5
    q[6:9, 2] = 0.05
    qd = rng.normal(0.0, 1.0, (n, dof)).astype(np.float32)
    tau = rng.uniform(-1.0, 1.0, (n, dof - 6)).astype(np.float32)
    return q, qd, tau


@pytest.mark.parametrize("conf", ["2x3", "1x1"])
def test_spaces_and_kinematics_match_jax(conf):
    args = {"scenario": "manyagent_ant", "agent_conf": conf}
    jenv, tenv = jma.make_manyagent_ant(args), make_env("mamujoco_jax", args, device="cpu")
    assert isinstance(tenv, tma.ManyAgentAnt) and tenv.n_agents == jenv.n_agents
    assert (tenv.dof, tenv.obs_dim, tenv.state_dim) == (jenv.dyn.dof, jenv.obs_dim,
                                                        jenv.state_dim)
    assert tenv.action_space[0].shape == jenv.action_space[0].shape
    dyn = jenv.dyn
    q, qd, _ = _states(dyn.dof)
    jp, jJ = jax.vmap(dyn._points)(q), jax.vmap(jax.jacfwd(dyn._points))(q)
    jab = jax.vmap(lambda a, b: jax.jvp(lambda qq: jax.jvp(dyn._points, (qq,), (b,))[1],
                                        (a,), (b,))[1])(q, qd)
    tp, tJ, tab = tenv.dyn.kinematics(torch.from_numpy(q), torch.from_numpy(qd))
    for t, j in ((tp, jp), (tJ, jJ), (tab, jab),
                 (tp[:, tenv.dyn.contact_idx], jax.vmap(dyn._contacts)(q)),
                 (tenv.dyn.masses, dyn.masses), (tenv.dyn.contact_radii, dyn.contact_radii)):
        _close(t, j, KIN_RTOL, 1e-5)
    lo, hi = dyn.q_limits
    _close(tenv.dyn.q_lo, lo, 0, 0)
    _close(tenv.dyn.q_hi, hi, 0, 0)


def test_substep_matches_jax_in_float64():
    dyn = jma.make_manyagent_ant({"agent_conf": "2x3"}).dyn
    tdyn = tma.make_manyagent_ant({"agent_conf": "2x3"}, torch.device("cpu")).dyn
    q, qd, tau = _states(dyn.dof, seed=1)
    _, jqd32, _ = jax.jit(jax.vmap(dyn._substep))(q, qd, tau)
    with jax.enable_x64(True):
        jq, jqd, jn = (np.asarray(x) for x in jax.jit(jax.vmap(dyn._substep))(
            *(x.astype(np.float64) for x in (q, qd, tau))))
    tq, tqd, tn = tdyn.substep(*(torch.from_numpy(x) for x in (q, qd, tau)))
    _close(tq, jq, KIN_RTOL, KIN_ATOL)
    _close(tn, jn, KIN_RTOL, KIN_ATOL)
    port, jax32 = (_share(x, jqd, KIN_RTOL, KIN_ATOL) for x in (tqd, jqd32))
    print(f"q̇' from float64: the port {port:.3f}, JAX's float32 substep {jax32:.3f} of the "
          f"tolerance")
    assert port <= 1.0 and port < jax32
    assert float(tn.min()) == 0.0 and float(tn.max()) > 100.0   # in the air, and in contact


def test_reset_and_free_steps_match_jax():
    """A reset from replayed draws, then 8 env steps of gentle actions
    (±0.3) on each side's own state, through the truncation at an episode
    limit of 6."""
    jenv = jma.make_manyagent_ant({"agent_conf": "2x3", "episode_limit": 6})
    tenv = make_env("mamujoco_jax", {"scenario": "manyagent_ant", "agent_conf": "2x3",
                                     "episode_limit": 6}, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(1), X)
    js, jts = jax.vmap(jenv.reset)(keys)
    ts, tts = tenv.reset(tuple(torch.from_numpy(np.array(x))
                               for x in reset_noise(keys, tenv.dof)))
    _close(ts.q, js.q, 1e-6, 1e-7)
    _close(tts.obs, jts.obs, 1e-5, 1e-5)
    jstep = jax.jit(jax.vmap(lambda s, a: jenv.step(s, a, None)))
    rng = np.random.default_rng(0)
    worst = 0.0
    for step in range(8):
        a = rng.uniform(-0.3, 0.3, (X, 2, 12)).astype(np.float32)
        js, jts = jstep(js, jnp.asarray(a))
        ts, tts = tenv.step(ts, torch.from_numpy(a))
        for t, j in ((ts.q, js.q), (ts.qd, js.qd), (tts.obs, jts.obs),
                     (tts.share_obs, jts.share_obs), (tts.rewards, jts.rewards)):
            worst = max(worst, _share(t, j))
        np.testing.assert_array_equal(tts.dones.numpy(), np.asarray(jts.dones))
        np.testing.assert_array_equal(tts.bad_transition.numpy(), np.asarray(jts.bad_transition))
        assert bool(tts.bad_transition.all()) == (step + 1 >= 6)
    print(f"worst element over 8 free steps: {worst:.3f} of the tolerance")
    assert worst <= 1.0
