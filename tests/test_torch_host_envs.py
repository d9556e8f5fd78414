"""Port parity of the host envs: ``HostVecEnv`` (``envs/host.py``), the gym
wrapper and MAMuJoCo on gymnasium's MuJoCo tasks, each against the JAX
package's class on the same actions from the same seeds, bitwise."""
import dataclasses
import time

import gymnasium
import numpy as np
import pytest

from harl_tpu.envs.gym.gym_env import make_gym as jmake_gym
from harl_tpu.envs.host import HostVecEnv as JHostVecEnv
from harl_tpu.envs.mamujoco.mamujoco import make_mamujoco as jmake_mamujoco
from harl_tpu_torch.envs import make_env
from harl_tpu_torch.envs.gym.gym_env import GymEnv, make_gym
from harl_tpu_torch.envs.host import HostVecEnv, vectorize
from harl_tpu_torch.envs.mamujoco.mamujoco import MAMuJoCoEnv, make_mamujoco
from harl_tpu_torch.utils import spaces

STEPS = 50


def _same_spaces(env, jenv):
    """The port's and the JAX package's space dataclasses describe the same
    spaces."""
    for name in ("observation_space", "share_observation_space", "action_space"):
        ours, theirs = getattr(env, name), getattr(jenv, name)
        assert [(type(a).__name__, dataclasses.asdict(a)) for a in ours] == [
            (type(b).__name__, dataclasses.asdict(b)) for b in theirs], name


class CountEnv:
    """A NumPy host env: float64 observations from its own generator, an
    availability row, episodes of a length drawn at each reset (2 to 5
    steps), the last of them a truncation on odd-seeded envs."""

    n_agents = 2
    observation_space = [spaces.Box.create(-1.0, 1.0, 3)] * 2
    share_observation_space = [spaces.Box.create(-1.0, 1.0, 4)] * 2
    action_space = [spaces.Discrete(3)] * 2

    def __init__(self):
        self.seeds = []
        self.rng = np.random.default_rng(0)

    def seed(self, seed):
        self.seeds.append(seed)
        self.rng = np.random.default_rng(seed)

    def _obs(self):
        return self.rng.normal(size=(2, 3)), self.rng.normal(size=4), np.ones((2, 3))

    def reset(self):
        self.t, self.limit = 0, int(self.rng.integers(2, 6))
        return self._obs()

    def step(self, actions):
        self.t += 1
        obs, share, avail = self._obs()
        avail[:, int(np.asarray(actions).reshape(-1)[0]) % 3] = 0.0
        done = self.t >= self.limit
        info = {"bad_transition": done and self.seeds[-1] % 2 == 1}
        return (obs, share, np.full((2, 1), float(np.sum(actions)), np.float64),
                np.full(2, done), [info, dict(info)], avail)


def _vec_pair(n, seed):
    return (HostVecEnv([CountEnv] * n, seed=seed), JHostVecEnv([CountEnv] * n, seed=seed))


def test_host_vec_env_matches_jax_with_auto_reset():
    vec, jvec = _vec_pair(5, 7)
    assert [e.seeds for e in vec.envs] == [[7 + 1000 * i] for i in range(5)]
    assert [e.seeds for e in vec.envs] == [e.seeds for e in jvec.envs]
    assert (vec.n_envs, vec.n_agents, vec.action_space) == (5, 2, CountEnv.action_space)
    for a, b in zip(vec.reset(), jvec.reset()):
        np.testing.assert_array_equal(a, b)
    acts_rng = np.random.default_rng(3)
    ended = 0
    for _ in range(12):
        acts = acts_rng.integers(0, 3, (5, 2, 1))
        out, jout = vec.step(acts), jvec.step(acts)
        assert set(out) == set(jout)
        for k in ("obs", "share_obs", "rewards", "available_actions", "final_obs",
                  "final_share_obs"):
            assert out[k].dtype == np.float32 == jout[k].dtype, k
            np.testing.assert_array_equal(out[k], jout[k], err_msg=k)
        assert out["dones"].dtype == bool and out["infos"] == jout["infos"]
        np.testing.assert_array_equal(out["dones"], jout["dones"])
        done = out["dones"].all(axis=1)
        ended += int(done.sum())
        # auto-reset: the fresh obs replaces the terminal one, kept apart
        assert not np.array_equal(out["obs"][done], out["final_obs"][done]) or not done.any()
        np.testing.assert_array_equal(out["obs"][~done], out["final_obs"][~done])
    assert ended >= 5
    vec.close()
    jvec.close()


def test_vectorize_uses_a_pre_vectorized_env_whole():
    class Batched:
        is_vectorized = True

        def ensure_envs(self, n, seed=1):
            self.sized = (n, seed)

    env = Batched()
    assert vectorize(env, "gym", {}, 6, seed=50000) is env and env.sized == (6, 50000)
    first = make_gym({"scenario": "CartPole-v1"})
    vec = vectorize(first, "gym", {"scenario": "Pendulum-v1"}, 3, seed=2)
    assert vec.envs[0] is first and [e._seed for e in vec.envs] == [2, 1002, 2002]
    assert [e.scenario for e in vec.envs] == ["CartPole-v1", "Pendulum-v1", "Pendulum-v1"]
    # a HostVecEnv handed over whole is reseeded, and must hold the envs asked for
    counts = HostVecEnv([CountEnv] * 2, seed=4)
    assert vectorize(counts, "gym", {}, 2) is counts
    assert [e.seeds for e in counts.envs] == [[4, 1], [1004, 1001]]
    with pytest.raises(ValueError, match="of 2 envs cannot run 3"):
        vectorize(counts, "gym", {}, 3)
    for v in (vec, counts):
        v.close()


def test_host_vec_env_steps_concurrently():
    """N envs step in about one env's time (tests/test_host_envs.py:93-134):
    8 envs × 30 ms serially would be ~240 ms a step."""

    class SleepEnv:
        n_agents = 2
        observation_space = [gymnasium.spaces.Box(-1, 1, (3,))] * 2
        share_observation_space = [gymnasium.spaces.Box(-1, 1, (6,))] * 2
        action_space = [gymnasium.spaces.Box(-1, 1, (2,))] * 2

        def seed(self, s):
            pass

        def reset(self):
            return np.zeros((2, 3), np.float32), np.zeros((2, 6), np.float32), None

        def step(self, actions):
            time.sleep(0.03)     # an external engine's call
            return (np.zeros((2, 3), np.float32), np.zeros((2, 6), np.float32),
                    np.zeros((2, 1), np.float32), np.zeros((2,), bool),
                    [{} for _ in range(2)], None)

    n = 8
    vec = HostVecEnv([SleepEnv for _ in range(n)])
    vec.reset()
    acts = np.zeros((n, 2, 2), np.float32)
    vec.step(acts)  # warm the pool
    t0 = time.time()
    for _ in range(3):
        out = vec.step(acts)
    dt = (time.time() - t0) / 3
    assert out["obs"].shape == (n, 2, 3)
    assert dt < 0.12, f"host vec step took {dt:.3f}s for {n} envs - serialized?"
    vec.close()


def _run_pair(env, jenv, actions):
    """Reset both from seed 11 and step both with ``actions(t)``; every
    output equal, bitwise. Returns the port's dones and infos by step."""
    env.seed(11)
    jenv.seed(11)
    for a, b in zip(env.reset(), jenv.reset()):
        np.testing.assert_array_equal(a, b)
    trace = []
    for t in range(STEPS):
        act = actions(t)
        out, jout = env.step(act), jenv.step(act)
        for a, b in zip(out, jout):
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b
        trace.append((out[3], out[4]))
        if np.all(out[3]):
            for a, b in zip(env.reset(), jenv.reset()):
                np.testing.assert_array_equal(a, b)
    env.close()
    jenv.close()
    return trace


@pytest.mark.parametrize("scenario", ["CartPole-v1", "Pendulum-v1"])
def test_gym_env_matches_jax(scenario):
    env, jenv = make_gym({"scenario": scenario}), jmake_gym({"scenario": scenario})
    assert isinstance(make_env("gym", {"scenario": scenario}, device="cpu"), GymEnv)
    _same_spaces(env, jenv)
    rng = np.random.default_rng(0)
    if scenario == "CartPole-v1":
        assert env.discrete and env.reset()[2].tolist() == [[1.0, 1.0]]
        trace = _run_pair(env, jenv, lambda t: rng.integers(0, 2, (1, 1)))
        # a pole falls: a termination, not a truncation
        ends = [infos for dones, infos in trace if dones.all()]
        assert ends and not any(i[0]["bad_transition"] for i in ends)
    else:
        assert not env.discrete and env.reset()[2] is None
        # Pendulum truncates at 200 steps; within 50 none ends
        trace = _run_pair(env, jenv, lambda t: rng.uniform(-2, 2, (1, 1)).astype(np.float32))
        assert not any(d.any() for d, _ in trace)
    # truncation without termination is a bad transition (gym_env.py:26-31)
    env = make_gym({"scenario": "Pendulum-v1"})
    env.env = gymnasium.wrappers.TimeLimit(env.env.unwrapped, max_episode_steps=3)
    env.reset()
    for _ in range(3):
        _, _, _, dones, infos, _ = env.step(np.zeros((1, 1), np.float32))
    assert dones.all() and infos[0]["bad_transition"] is True


@pytest.mark.parametrize("scenario,conf,limit", [("HalfCheetah-v2", "6x1", 20),
                                                 ("HalfCheetah-v2", "3x2", 20),
                                                 ("Hopper-v2", "3x1", 1000)])
def test_mamujoco_env_matches_jax(scenario, conf, limit):
    args = {"scenario": scenario, "agent_conf": conf, "episode_limit": limit}
    env, jenv = make_mamujoco(args), jmake_mamujoco(dict(args))
    assert isinstance(make_env("mamujoco", dict(args, backend="gym"), device="cpu"),
                      MAMuJoCoEnv)
    _same_spaces(env, jenv)
    width = env.action_space[-1].dim
    rng = np.random.default_rng(1)
    hop = scenario.startswith("Hopper")
    # Hopper falls under a constant push; the cheetah runs free
    trace = _run_pair(env, jenv, (lambda t: np.full((env.n_agents, width), 0.8, np.float32))
                      if hop else
                      (lambda t: rng.uniform(-1, 1, (env.n_agents, width)).astype(np.float32)))
    ends = [infos for dones, infos in trace if dones.all()]
    assert ends
    # the cheetah's ends are truncations at the limit; the hopper's a fall
    assert all(i[0]["bad_transition"] is not hop for i in ends)
