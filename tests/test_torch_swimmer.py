"""Port parity: the many-agent swimmer (``envs/mamujoco_jax/swimmer.py``)
against the JAX env.

The written-out J and bias acceleration are held against ``jax.jacfwd``
and the nested ``jax.jvp`` at rtol 1e-5 / atol 1e-6. One substep is held
against the JAX substep run in float64 (``jax.enable_x64``) at rtol 1e-5 /
atol 1e-6: the JAX env's own float32 substep of the 23×23 system (10x2)
lands ~37 of that tolerance from its float64 substep in q̇′ (up to ~200 from
other states), while the port, which assembles and solves the system in
float64, lands ~0.2 of it; the test asserts the port is the closer. A reset from replayed draws
and free env steps are held at the planar tolerance (rtol 1e-4 / atol
2e-4) against the JAX env run in float64, through the truncation at
``episode_limit``: the JAX env's own float32 run drifts past that
tolerance within a few steps.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harl_tpu.envs.mamujoco_jax import swimmer as jsw
from harl_tpu_torch.envs import make_env
from harl_tpu_torch.envs.mamujoco_jax import swimmer as tsw

from tests.torch_replay import swimmer_reset_noise

KIN_RTOL, KIN_ATOL = 1e-5, 1e-6
RTOL, ATOL = 1e-4, 2e-4
X = 8


def _share(a, b, rtol=RTOL, atol=ATOL):
    """The worst element's distance as a share of the tolerance."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / (atol + rtol * np.abs(b))).max())


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _states(L, seed=0, n=12):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1.0, 1.0, (n, L + 2)).astype(np.float32)
    qd = rng.normal(0.0, 2.0, (n, L + 2)).astype(np.float32)
    tau = rng.uniform(-2.0, 2.0, (n, L - 1)).astype(np.float32)
    return q, qd, tau


@pytest.mark.parametrize("conf", ["4x2", "10x2", "2x1"])
def test_spaces_and_kinematics_match_jax(conf):
    args = {"scenario": "manyagent_swimmer", "agent_conf": conf}
    jenv, tenv = jsw.make_swimmer(args), make_env("mamujoco_jax", args, device="cpu")
    assert isinstance(tenv, tsw.ManyAgentSwimmer) and tenv.n_agents == jenv.n_agents
    assert tenv.n_links == jenv.n_links
    assert tenv.observation_space[0].shape == jenv.observation_space[0].shape
    assert tenv.share_observation_space[0].shape == jenv.share_observation_space[0].shape
    assert tenv.action_space[0].shape == jenv.action_space[0].shape
    L = jenv.n_links
    q, qd, _ = _states(L)
    centers = lambda qq: jsw._link_centers(qq, L)
    jJ = jax.vmap(jax.jacfwd(centers))(q)
    jb = jax.vmap(lambda a, b: jax.jvp(lambda qq: jax.jvp(centers, (qq,), (b,))[1],
                                       (a,), (b,))[1])(q, qd)
    tJ, tb, _ = tenv.dyn.kinematics(torch.from_numpy(q), torch.from_numpy(qd))
    _close(tJ, jJ, KIN_RTOL, KIN_ATOL)
    _close(tb, jb, KIN_RTOL, KIN_ATOL)


def test_swimmer_v2_routes_to_the_swimmer():
    env = make_env("mamujoco_jax", {"scenario": "Swimmer-v2", "agent_conf": "2x1"}, device="cpu")
    assert isinstance(env, tsw.ManyAgentSwimmer) and env.n_links == 3
    assert isinstance(make_env("manyagent_swimmer", {}, device="cpu"), tsw.ManyAgentSwimmer)


def test_substep_matches_jax_in_float64():
    env = jsw.make_swimmer({"agent_conf": "10x2"})
    L = env.n_links
    q, qd, tau = _states(L, seed=1)
    sub = jax.jit(jax.vmap(lambda a, b, c: env._substep(a, b, c, jsw.DT / 2)))
    _, jqd32 = sub(q, qd, tau)
    with jax.enable_x64(True):
        jq, jqd = (np.asarray(x) for x in jax.jit(jax.vmap(
            lambda a, b, c: env._substep(a, b, c, jsw.DT / 2)))(
                *(x.astype(np.float64) for x in (q, qd, tau))))
    dyn = tsw.SwimmerDynamics(L, torch.device("cpu"))
    tq, tqd = dyn.substep(*(torch.from_numpy(x) for x in (q, qd, tau)), jsw.DT / 2)
    _close(tq, jq, KIN_RTOL, KIN_ATOL)
    port, jax32 = (_share(x, jqd, KIN_RTOL, KIN_ATOL) for x in (tqd, jqd32))
    print(f"q̇' from float64: the port {port:.3f}, JAX's float32 substep {jax32:.3f} of the "
          f"tolerance")
    assert port <= 1.0 and port < jax32


@functools.lru_cache(maxsize=None)
def _jax_fns(conf, limit):
    jenv = jsw.make_swimmer({"agent_conf": conf, "episode_limit": limit})
    return (jenv, jax.jit(jax.vmap(jenv.reset)),
            jax.jit(jax.vmap(lambda s, a: jenv.step(s, a, None))))


def test_reset_and_free_steps_match_jax_in_float64():
    """A reset from replayed draws, then 8 env steps of random actions on
    each side's own state, through the truncation at an episode limit of 5.
    The JAX env's own float32 run drifts from its float64 run past the
    planar tolerance within 5 steps (to ~37 of it by step 9: every
    substep's float32 solve loses tens of rtol 1e-5 in q̇′), so the port's
    run is held against the JAX env run in float64 and must be the closer
    of the two; dones and truncations equal the float32 run's."""
    jenv, jreset, jstep = _jax_fns("4x2", 5)
    tenv = make_env("mamujoco_jax", {"scenario": "manyagent_swimmer", "agent_conf": "4x2",
                                     "episode_limit": 5}, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(1), X)
    js, jts = jreset(keys)
    ts, tts = tenv.reset(tuple(torch.from_numpy(np.array(x))
                               for x in swimmer_reset_noise(keys, jenv.n_links)))
    _close(ts.q, js.q, 1e-6, 1e-7)
    _close(tts.obs, jts.obs, 1e-5, 1e-5)
    with jax.enable_x64(True):
        js64 = jax.tree.map(lambda x: jnp.asarray(
            np.asarray(x, np.float64) if x.dtype == jnp.float32 else np.asarray(x)), js)
        jstep64 = jax.jit(jax.vmap(lambda s, a: jenv.step(s, a, None)))
    rng = np.random.default_rng(0)
    worst = worst32 = 0.0
    for step in range(8):
        a = rng.uniform(-1.0, 1.0, (X, 4, 2)).astype(np.float32)
        js, jts = jstep(js, jnp.asarray(a))
        ts, tts = tenv.step(ts, torch.from_numpy(a))
        with jax.enable_x64(True):
            js64, jts64 = jstep64(js64, jnp.asarray(a, jnp.float64))
        for t, j, j64 in ((ts.q, js.q, js64.q), (ts.qd, js.qd, js64.qd),
                          (tts.obs, jts.obs, jts64.obs),
                          (tts.share_obs, jts.share_obs, jts64.share_obs),
                          (tts.rewards, jts.rewards, jts64.rewards)):
            worst = max(worst, _share(t, j64))
            worst32 = max(worst32, _share(j, j64))
        np.testing.assert_array_equal(tts.dones.numpy(), np.asarray(jts.dones))
        np.testing.assert_array_equal(tts.bad_transition.numpy(), np.asarray(jts.bad_transition))
        assert bool(tts.bad_transition.all()) == (step + 1 >= 5)
    print(f"worst element over 8 free steps from float64: the port {worst:.3f}, JAX's "
          f"float32 run {worst32:.3f} of the tolerance")
    assert worst <= 1.0 and worst < worst32
