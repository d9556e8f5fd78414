"""Port parity: the air-combat env against the JAX package's
``envs/lag_jax/aircombat.py``.

A reset from replayed draws, then steps of random MultiDiscrete actions
from dogfight states built with numpy (aircraft within ~1.5 km of each
other at random headings, some low and diving), so that allies and enemies
are shot down and some fly below the altitude band within the 25 steps.
The JAX env is vmapped over the batch. Dones, alive flags, ``won`` and
``bad_transition`` must be equal. Floats are held at rtol 1e-5 / atol 1e-6,
except what goes through the aspect angle arccos(clip(cos)): near cos = ±1
one float32 ulp of the cosine moves the angle by ~3.5e-4 rad, so the reward
(whose posture term reads (1 − ao/π)) is held at atol 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harl_tpu.envs.lag_jax import aircombat as jac
from harl_tpu_torch.envs import make_env
from harl_tpu_torch.envs.lag_jax import aircombat as tac

from tests.torch_replay import aircombat_reset_noise

X, STEPS = 64, 25
RTOL, ATOL = 1e-5, 1e-6
REWARD_ATOL = 1e-3
# XLA's float32 sin, cos, atan2 and exp are its own polynomials, an ulp off
# torch's now and then, and the flight path integrates them: positions
# drift by ulps, and the bearing sin/cos of an enemy a few metres away
# moves by ~1e-5
OBS_ATOL = 2e-5
# positions are metres of magnitude up to ~5000 (a float32 ulp there is
# 4.9e-4) that pass near 0 on a turn; speeds up to 340 m/s
STATE_ATOL = {"pos": 1e-3, "v": 1e-4, "psi": ATOL, "gamma": ATOL}


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=atol)


def _dogfight_state(rng, n_allies, n_enemies):
    A = n_allies + n_enemies
    pos = rng.uniform(-700.0, 700.0, (X, A, 3)).astype(np.float32)
    pos[..., 2] += 3000.0
    low = rng.uniform(size=(X, A)) < 0.15           # some dive near the floor
    pos[..., 2] = np.where(low, rng.uniform(100.0, 160.0, (X, A)), pos[..., 2])
    gamma = np.where(low, -0.5, rng.uniform(-0.3, 0.3, (X, A))).astype(np.float32)
    return dict(pos=pos, v=rng.uniform(150.0, 300.0, (X, A)).astype(np.float32),
                psi=rng.uniform(-np.pi, np.pi, (X, A)).astype(np.float32), gamma=gamma,
                health=rng.choice([1.0, 0.6, 0.2], (X, A)).astype(np.float32),
                alive=rng.uniform(size=(X, A)) < 0.95, t=np.full(X, 280, np.int32))


def _check(tts, jts):
    _close(tts.obs, jts.obs, OBS_ATOL)
    _close(tts.share_obs, jts.share_obs, OBS_ATOL)
    _close(tts.rewards, jts.rewards, REWARD_ATOL)
    np.testing.assert_array_equal(tts.dones.numpy(), np.asarray(jts.dones))
    np.testing.assert_array_equal(tts.bad_transition.numpy(), np.asarray(jts.bad_transition))
    np.testing.assert_array_equal(tts.metrics["won"].numpy(), np.asarray(jts.metrics["won"]))
    assert tts.available_actions is None and jts.available_actions is None


def test_spawn_lines_match_jax_linspace():
    """Exact up to 7 aircraft a side; beyond, within two float32 ulps of
    1000 (1.2e-4 m) of it."""
    for n in range(1, 12):
        env = tac.AirCombat(n_allies=n, n_enemies=1)
        ref = np.asarray(jax.jit(lambda: jnp.linspace(-1000.0, 1000.0, n))())
        if n <= 7:
            np.testing.assert_array_equal(env.ay.numpy(), ref)
        np.testing.assert_allclose(env.ay.numpy(), ref, rtol=0, atol=1.25e-4)


@pytest.mark.parametrize("scenario", ["2v2", "1v1", "3v2"])
def test_reset_and_steps_match_jax(scenario):
    env_args = {"scenario": scenario, "episode_limit": 300}
    jenv = jac.make_aircombat(env_args)
    tenv = make_env("lag_jax", env_args, device="cpu")
    assert (tenv.n_agents, tenv.obs_dim, tenv.state_dim) == (
        jenv.n_agents, jenv.obs_dim, jenv.state_dim)
    assert tenv.action_space[0].nvec == jenv.action_space[0].nvec == (11, 11, 10)
    N, A = jenv.n_allies, jenv.A

    # reset from replayed draws (aircombat.py:122-131)
    keys = jax.random.split(jax.random.PRNGKey(3), X)

    jstate, jts = jax.vmap(jenv.reset)(keys)
    tstate, tts = tenv.reset(tuple(torch.from_numpy(np.array(x))
                                   for x in aircombat_reset_noise(keys, N, jenv.n_enemies)))
    for name in ("pos", "v", "psi", "gamma", "health"):
        _close(getattr(tstate, name), getattr(jstate, name))
    _check(tts, jts)

    rng = np.random.default_rng(7)
    s = _dogfight_state(rng, N, jenv.n_enemies)
    jstate = jac.AirCombatState(**{k: jnp.asarray(v) for k, v in s.items()})
    tstate = tac.AirCombatState(**{k: torch.from_numpy(v) for k, v in s.items()})
    jstep = jax.jit(jax.vmap(jenv.step))
    downed_ally = downed_enemy = low_kill = ended = 0
    for _ in range(STEPS):
        acts = np.stack([rng.integers(0, n, (X, N)) for n in (11, 11, 10)], axis=-1)
        prev_alive = np.asarray(jstate.alive)
        jstate, jts = jstep(jstate, jnp.asarray(acts, jnp.int32), keys)
        tstate, tts = tenv.step(tstate, torch.from_numpy(acts))
        _check(tts, jts)
        np.testing.assert_array_equal(tstate.alive.numpy(), np.asarray(jstate.alive))
        np.testing.assert_array_equal(tstate.health.numpy(), np.asarray(jstate.health))
        for name in ("pos", "v", "psi", "gamma"):
            _close(getattr(tstate, name), getattr(jstate, name), STATE_ATOL[name])
        alive = np.asarray(jstate.alive)
        gone = prev_alive & ~alive
        downed_ally += gone[:, :N].sum()
        downed_enemy += gone[:, N:].sum()
        low_kill += (gone & (np.asarray(jstate.pos)[..., 2] <= jac.ALT_MIN)).sum()
        ended += np.asarray(jts.dones).all(axis=1).sum()
        # keep stepping the ended envs from where they are: dead aircraft stay dead
    assert downed_ally > 0 and downed_enemy > 0 and low_kill > 0 and ended > 0


def test_make_aircombat_parses_scenarios():
    for scenario, (n, e) in (("2v2", (2, 2)), ("MultipleCombat/4v3", (4, 3)), ("x", (2, 2))):
        env = make_env("lag_jax", {"scenario": scenario}, device="cpu")
        assert (env.n_allies, env.n_enemies) == (n, e)
        assert make_env("aircombat", {"scenario": scenario}, device="cpu").n_agents == n
