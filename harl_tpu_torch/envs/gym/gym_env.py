"""Single-agent gymnasium wrapper, one agent (counterpart of
``harl_tpu/envs/gym/gym_env.py``; reference ``harl/envs/gym/gym_env.py``).

A truncation without termination sets ``bad_transition``
(gym_env.py:26-31); a Discrete action space gets an all-ones availability
row. ``reset`` seeds gymnasium with the env's seed and counts it up, so
every episode of an env starts from its own seed.
"""
from __future__ import annotations

import numpy as np

from harl_tpu_torch.utils import spaces


class GymEnv:
    is_jax = False

    def __init__(self, env_args: dict):
        import gymnasium as gym

        self.scenario = env_args.get("scenario", "CartPole-v1")
        self.env = gym.make(self.scenario)
        self.n_agents = 1
        self._seed = 0
        obs_dim = int(np.prod(self.env.observation_space.shape))
        self.observation_space = [spaces.Box.create(-np.inf, np.inf, obs_dim)]
        self.share_observation_space = [spaces.Box.create(-np.inf, np.inf, obs_dim)]
        sp = self.env.action_space
        if hasattr(sp, "n"):
            self.action_space = [spaces.Discrete(int(sp.n))]
            self.discrete = True
        else:
            self.action_space = [spaces.Box(tuple(map(float, sp.low)), tuple(map(float, sp.high)))]
            self.discrete = False

    def seed(self, seed: int) -> None:
        self._seed = seed

    def reset(self):
        obs, _ = self.env.reset(seed=self._seed)
        self._seed += 1
        obs = np.asarray(obs, np.float32).reshape(1, -1)
        return obs, obs[0], self._avail()

    def _avail(self):
        if self.discrete:
            return np.ones((1, self.action_space[0].n), np.float32)
        return None

    def step(self, actions):
        a = actions[0]
        if self.discrete:
            a = int(np.asarray(a).reshape(-1)[0])
        else:
            a = np.asarray(a, np.float32)[: self.action_space[0].dim]
        obs, reward, term, trunc, _ = self.env.step(a)
        obs = np.asarray(obs, np.float32).reshape(1, -1)
        done = bool(term) or bool(trunc)
        infos = [{"bad_transition": bool(trunc) and not bool(term)}]
        return obs, obs[0], np.array([[reward]], np.float32), np.array([done]), infos, \
            self._avail()

    def close(self) -> None:
        self.env.close()


def make_gym(env_args: dict) -> GymEnv:
    return GymEnv(env_args)
