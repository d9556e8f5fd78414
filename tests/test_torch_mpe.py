"""Port parity: the MPE scenarios against the JAX package's ``envs/mpe/mpe.py``.

The JAX env is vmapped over a small batch through its ``VecEnv``; the port
steps the same batch as one tensor from the same reset draws (replayed from
the JAX keys) and takes the same actions, through truncation at
``max_cycles`` and the auto-reset after it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harl_tpu.envs import core as jcore
from harl_tpu.envs import make_env as jmake_env
from harl_tpu.utils.config_tools import get_defaults_yaml_args as jdefaults
from harl_tpu_torch.envs import core as tcore
from harl_tpu_torch.envs import make_env
from harl_tpu_torch.utils import spaces
from harl_tpu_torch.utils.config_tools import get_defaults_yaml_args

from tests.torch_replay import mpe_reset_noise, step_mpe_reset_noise

X, STEPS, CYCLES = 6, 30, 25
# float32 point masses: the two sides round the contact's softplus and the
# norms in another order, a few ulps a step
RTOL, ATOL = 1e-5, 1e-6
SCENARIOS = ["simple_spread_v2", "simple_reference_v2", "simple_speaker_listener_v3"]
CASES = [(s, c) for s in SCENARIOS for c in (True, False)]


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL)


def _t(x):
    return torch.from_numpy(np.array(x))


def _actions(rng, env, continuous):
    """One step of random actions, stacked (X, N, width) and padded."""
    acts = []
    for sp in env.action_space:
        if continuous:
            a = rng.uniform(0, 1, (X, sp.dim)).astype(np.float32)
            acts.append(np.pad(a, ((0, 0), (0, env.max_action_n - sp.dim))))
        else:
            acts.append(rng.integers(0, sp.n, (X, 1)).astype(np.int32))
    return np.stack(acts, axis=1)


def _check(tts, jts, continuous):
    for name in ("obs", "share_obs", "rewards"):
        _close(getattr(tts, name), getattr(jts, name))
    np.testing.assert_array_equal(tts.dones.numpy(), np.asarray(jts.dones))
    np.testing.assert_array_equal(tts.bad_transition.numpy(), np.asarray(jts.bad_transition))
    if continuous:
        assert tts.available_actions is None and jts.available_actions is None
    else:
        np.testing.assert_array_equal(tts.available_actions.numpy(),
                                      np.asarray(jts.available_actions))


@pytest.mark.parametrize("scenario,continuous", CASES,
                         ids=[f"{s}-{'continuous' if c else 'discrete'}" for s, c in CASES])
def test_reset_and_steps_match_jax(scenario, continuous):
    env_args = {"scenario": scenario, "continuous_actions": continuous}
    jenv = jmake_env("pettingzoo_mpe", env_args)
    tenv = make_env("pettingzoo_mpe", env_args, device="cpu")
    assert tenv.n_agents == jenv.n_agents and tenv.max_cycles == CYCLES
    assert tenv.obs_dims == jenv.obs_dims and tenv.max_action_n == jenv.max_action_n
    for tsp, jsp in zip(tenv.action_space, jenv.action_space):
        assert spaces.space_kind(tsp) == type(jsp).__name__
        assert (tsp.n if hasattr(tsp, "n") else tsp.dim) == (
            jsp.n if hasattr(jsp, "n") else jsp.dim)
    goals = scenario != "simple_spread_v2"
    key = jax.random.PRNGKey(1)
    jvec = jcore.VecEnv(jenv, X)
    jstate, jts = jvec.reset(key)
    tstate, tts = tenv.reset(tuple(_t(x) for x in mpe_reset_noise(
        jax.random.split(key, X), tenv.n_agents, goals)))
    _check(tts, jts, continuous)
    np.testing.assert_array_equal(tstate.goals.numpy(), np.asarray(jstate.goals))
    rng = np.random.default_rng(2)
    step = jax.jit(jvec.step)
    ends = 0
    for k in range(STEPS):
        a = _actions(rng, tenv, continuous)
        k_env = jax.random.fold_in(jax.random.PRNGKey(3), k)
        jtr = step(jstate, jnp.asarray(a), k_env)
        ttr = tcore.auto_reset_step(tenv, tstate, _t(a), tuple(
            _t(x) for x in step_mpe_reset_noise(k_env, X, tenv.n_agents, goals)))
        _check(ttr.ts, jtr.ts, continuous)
        _check(ttr.final, jtr.final, continuous)
        for name in ("agent_pos", "agent_vel", "agent_comm", "landmark_pos"):
            _close(getattr(ttr.state, name), getattr(jtr.state, name))
        for name in ("goals", "t"):
            np.testing.assert_array_equal(getattr(ttr.state, name).numpy(),
                                          np.asarray(getattr(jtr.state, name)))
        ends += int(ttr.ts.dones.all(dim=1).sum())
        jstate, tstate = jtr.state, ttr.state
    # every env truncated at max_cycles (bad_transition with the done) once
    assert ends == X


def test_simple_spread_collisions_and_self_collision():
    """Overlapping agents push apart with the soft-core force, and every
    agent pays its own collision: −1 an agent a step at local_ratio 1."""
    env_args = {"scenario": "simple_spread_v2", "local_ratio": 1.0}
    jenv = jmake_env("pettingzoo_mpe", env_args)
    tenv = make_env("pettingzoo_mpe", env_args, device="cpu")
    key = jax.random.PRNGKey(4)
    jstate, _ = jcore.VecEnv(jenv, X).reset(key)
    tstate, _ = tenv.reset(tuple(_t(x) for x in mpe_reset_noise(
        jax.random.split(key, X), 3, False)))
    # agents 0 and 1 of every env 0.05 apart (sizes 0.15: overlapping), or
    # on top of each other but for 1e-6
    pos = np.array(jstate.agent_pos)
    pos[:, 1] = pos[:, 0] + np.array([0.05, 0.0], np.float32)
    pos[::2, 1] = pos[::2, 0] + np.array([1e-6, 0.0], np.float32)
    jstate = jstate._replace(agent_pos=jnp.asarray(pos))
    tstate = tstate._replace(agent_pos=_t(pos))
    a = np.zeros((X, 3, 5), np.float32)
    jstate, jts = jax.vmap(lambda s, a: jenv.step(s, a, None))(jstate, jnp.asarray(a))
    tstate, tts = tenv.step(tstate, _t(a))
    _close(tstate.agent_vel, jstate.agent_vel)
    _close(tts.rewards, jts.rewards)
    gap = (tstate.agent_pos[:, 1, 0] - tstate.agent_pos[:, 0, 0]).numpy()
    assert (gap > np.where(np.arange(X) % 2 == 0, 1e-6, 0.05)).all()
    # each of the 3 agents collides with itself; 0 and 1, 1e-6 apart, also
    # with each other after the step, while the pair 0.05 apart has been
    # pushed out of contact
    np.testing.assert_array_equal(tts.rewards[:, 0, 0].numpy(), [-5.0, -3.0] * (X // 2))


@pytest.mark.parametrize("continuous", [True, False])
def test_speaker_listener_pads_and_masks(continuous):
    """Speaker obs 3 wide padded to 11, share_obs the 14 unpadded values;
    Discrete(3) and Discrete(5) availability rows; the speaker never moves."""
    tenv = make_env("mpe", {"scenario": "simple_speaker_listener_v3",
                            "continuous_actions": continuous, "max_cycles": 7},
                    device="cpu")
    assert tenv.max_cycles == 7 and tenv.obs_dims == (3, 11)
    g = torch.Generator().manual_seed(0)
    noise = (torch.rand((4, 4), generator=g), torch.rand((4, 6), generator=g),
             torch.randint(0, 3, (4, 2), generator=g))
    state, ts = tenv.reset(noise)
    assert ts.obs.shape == (4, 2, 11) and ts.share_obs.shape == (4, 14)
    assert float(ts.obs[:, 0, 3:].abs().sum()) == 0.0
    torch.testing.assert_close(ts.share_obs[:, :3], ts.obs[:, 0, :3])
    if continuous:
        assert ts.available_actions is None
        a = torch.rand((4, 2, 5), generator=g)
    else:
        assert ts.available_actions[0].tolist() == [[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]]
        a = torch.tensor([[[2], [1]]] * 4)
    before = state.agent_pos[:, 0].clone()
    state, ts = tenv.step(state, a)
    torch.testing.assert_close(state.agent_pos[:, 0], before, rtol=0, atol=0)
    if not continuous:   # the one-hot comm reaches the listener's obs
        assert ts.obs[:, 1, 8:].tolist() == [[0.0, 0.0, 1.0]] * 4


def test_env_yaml_copy_matches():
    """The port's pettingzoo_mpe.yaml holds the JAX package's defaults."""
    assert get_defaults_yaml_args("happo", "pettingzoo_mpe")[1] == jdefaults(
        "happo", "pettingzoo_mpe")[1]
