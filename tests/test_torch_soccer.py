"""Port parity: academy soccer against the JAX package's
``envs/football_jax/soccer.py``, for every scenario of ``SCENARIOS`` (the
10-vs-11 ``single_goal_versus_lazy`` included) and both representations.

A reset from replayed draws is held at rtol 1e-5 / atol 1e-6 (the spawn
lines are ``linspace32``, within an ulp of the JAX env's jitted
``jnp.linspace``). Then both envs step the JAX reset state for 50 steps of
random actions, without auto-reset, so that envs that ended go on with the
right team holding the ball: the clamped gathers of a right-team carrier
are exercised. Owner, carrier, checkpoints, dones, ``bad_transition`` and
``won`` must be equal, the pixel rasters too; floats at rtol 1e-5 /
atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harl_tpu.envs.football_jax import soccer as jsoc
from harl_tpu_torch.envs import make_env
from harl_tpu_torch.envs.football_jax import soccer as tsoc

from tests.torch_replay import soccer_reset_noise

X, STEPS = 64, 50
RTOL, ATOL = 1e-5, 1e-6


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _check(tts, jts):
    _close(tts.obs, jts.obs)
    _close(tts.share_obs, jts.share_obs)
    _close(tts.rewards, jts.rewards)
    _eq(tts.dones, jts.dones)
    _eq(tts.bad_transition, jts.bad_transition)
    _eq(tts.metrics["won"], jts.metrics["won"])
    _eq(tts.available_actions, jts.available_actions)


CASES = [(s, "simple") for s in tsoc.SCENARIOS] + [
    ("academy_3_vs_1_with_keeper", "pixels"), ("academy_single_goal_versus_lazy", "pixels")]


@pytest.mark.parametrize("scenario,representation", CASES,
                         ids=[f"{s}-{r}" for s, r in CASES])
def test_reset_and_steps_match_jax(scenario, representation):
    env_args = {"env_name": scenario, "representation": representation, "episode_limit": 30}
    jenv = jsoc.make_soccer(env_args)
    tenv = make_env("football_jax", env_args, device="cpu")
    N, M = jenv.n_agents, jenv.n_defenders
    assert (tenv.n_agents, tenv.n_defenders, tenv.obs_dim, tenv.state_dim) == (
        N, M, jenv.obs_dim, jenv.state_dim)
    assert tenv.observation_space[0].shape == jenv.observation_space[0].shape
    keys = jax.random.split(jax.random.PRNGKey(11), X)
    jstate, jts = jax.vmap(jenv.reset)(keys)
    tstate, tts = tenv.reset(tuple(torch.from_numpy(np.array(x))
                                   for x in soccer_reset_noise(keys, N, M)))
    for name in ("left_pos", "right_pos", "ball_pos"):
        _close(getattr(tstate, name), getattr(jstate, name))
    _check(tts, jts)

    tstate = tsoc.SoccerState(*(torch.from_numpy(np.array(x)) for x in jstate))
    jstep = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(5)
    ends = np.zeros(4, int)       # goal, lost, out, timeout
    for _ in range(STEPS):
        acts = rng.integers(0, tsoc.N_ACTIONS, (X, N, 1))
        prev_owner = np.asarray(jstate.owner)
        jstate, jts = jstep(jstate, jnp.asarray(acts, jnp.int32), keys)
        tstate, tts = tenv.step(tstate, torch.from_numpy(acts))
        _check(tts, jts)
        for name in ("owner", "carrier", "checkpoints", "sprint", "t"):
            _eq(getattr(tstate, name), getattr(jstate, name))
        for name in ("left_pos", "left_vel", "right_pos", "right_vel", "ball_pos", "ball_vel"):
            _close(getattr(tstate, name), getattr(jstate, name))
        fresh = prev_owner != 2          # envs still in play before this step
        won = np.asarray(jts.metrics["won"]) > 0
        lost = np.asarray(jstate.owner) == 2
        done = np.asarray(jts.dones)[:, 0]
        bad = np.asarray(jts.bad_transition)
        ends += [(fresh & won).sum(), (fresh & lost & ~won).sum(),
                 (fresh & done & ~won & ~lost & ~bad).sum(), (fresh & bad).sum()]
    assert ends.sum() > 0, ends


def test_make_soccer_names_and_refusals():
    env = make_env("soccer", {"scenario": "academy_corner"}, device="cpu")
    assert (env.n_agents, env.n_defenders) == (4, 3)
    with pytest.raises(ValueError):
        make_env("football_jax", {"env_name": "11_vs_11_stochastic"}, device="cpu")
