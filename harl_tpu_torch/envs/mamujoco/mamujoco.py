"""Multi-Agent MuJoCo on gymnasium's MuJoCo tasks, stepped on the host
(counterpart of ``harl_tpu/envs/mamujoco/mamujoco.py``; reference
``harl/envs/mamujoco/multiagent_mujoco/mujoco_multi.py``).

A single-robot gymnasium task factorized into per-joint agents, as HARL
uses it (the vendored k-hop ``build_obs`` path is bypassed there,
mujoco_multi.py:200-213):

  * agents are contiguous partitions of the action vector by ``agent_conf``
    "NxM" (N agents of M joints; leftover joints go to the last agent);
  * agent obs = concat(full state, one-hot agent id), standardized by the
    vector's own mean and std (mujoco_multi.py:208-211);
  * share_obs = the raw full state; the team reward is repeated per agent;
  * actions arrive in [-1, 1] and are rescaled to the robot's bounds;
    padding columns of narrower agents are dropped (mujoco_multi.py:159-166);
  * truncation at ``episode_limit`` sets ``bad_transition``
    (mujoco_multi.py:178-185).

Scenario names accept the reference's "-v2" ids (mapped to gymnasium's v5
tasks) and gymnasium's own.
"""
from __future__ import annotations

import numpy as np

from harl_tpu_torch.utils import spaces

_SCENARIO_MAP = {
    "HalfCheetah-v2": "HalfCheetah-v5",
    "Ant-v2": "Ant-v5",
    "Walker2d-v2": "Walker2d-v5",
    "Hopper-v2": "Hopper-v5",
    "Humanoid-v2": "Humanoid-v5",
    "HumanoidStandup-v2": "HumanoidStandup-v5",
    "Swimmer-v2": "Swimmer-v5",
    "Reacher-v2": "Reacher-v5",
}


def act_slices(total_act: int, agent_conf: str):
    """(n_agents, per-agent action widths, [(start, end)] of each agent's
    contiguous actuators) of an "NxM" ``agent_conf``."""
    n_agents, joints = (int(x) for x in agent_conf.split("x"))
    if n_agents * joints > total_act:
        raise ValueError(f"agent_conf {agent_conf} exceeds action dim {total_act}")
    sizes = [joints] * n_agents
    sizes[-1] += total_act - n_agents * joints
    starts = np.cumsum([0] + sizes)
    return n_agents, sizes, [(int(s), int(e)) for s, e in zip(starts[:-1], starts[1:])]


class MAMuJoCoEnv:
    is_jax = False

    def __init__(self, env_args: dict):
        import gymnasium as gym

        self.scenario = env_args.get("scenario", "HalfCheetah-v2")
        self.agent_conf = env_args.get("agent_conf", "6x1")
        self.episode_limit = env_args.get("episode_limit", 1000)
        self.env = gym.make(_SCENARIO_MAP.get(self.scenario, self.scenario))
        self.steps = 0
        self._seed = 0
        self.n_agents, sizes, self._act_slices = act_slices(
            self.env.action_space.shape[0], self.agent_conf)
        self._low = np.asarray(self.env.action_space.low, np.float32)
        self._high = np.asarray(self.env.action_space.high, np.float32)
        state_dim = int(np.prod(self.env.observation_space.shape))
        self.observation_space = [spaces.Box.create(-10.0, 10.0, state_dim + self.n_agents)
                                  for _ in range(self.n_agents)]
        self.share_observation_space = [spaces.Box.create(-10.0, 10.0, state_dim)
                                        for _ in range(self.n_agents)]
        self.action_space = [spaces.Box.create(-1.0, 1.0, s) for s in sizes]
        self._state = None

    def seed(self, seed: int) -> None:
        self._seed = seed

    def reset(self):
        state, _ = self.env.reset(seed=self._seed)
        self._seed += 1
        self.steps = 0
        self._state = np.asarray(state, np.float32)
        return self._obs(), self._state, None

    def step(self, actions):
        """``actions`` (n_agents, max act width) in [-1, 1]; padding dropped."""
        flat = np.concatenate([np.asarray(actions[i])[: e - s]
                               for i, (s, e) in enumerate(self._act_slices)]).astype(np.float32)
        flat = np.clip(flat, -1.0, 1.0)
        scaled = self._low + (flat + 1.0) * 0.5 * (self._high - self._low)
        state, reward, term, trunc, _ = self.env.step(scaled)
        self.steps += 1
        self._state = np.asarray(state, np.float32)
        done = bool(term) or bool(trunc) or self.steps >= self.episode_limit
        bad = done and not bool(term)
        infos = [{"bad_transition": bad} for _ in range(self.n_agents)]
        rewards = np.full((self.n_agents, 1), float(reward), np.float32)
        dones = np.full((self.n_agents,), done)
        return self._obs(), self._state, rewards, dones, infos, None

    def _obs(self):
        out = []
        for i in range(self.n_agents):
            oh = np.zeros(self.n_agents, np.float32)
            oh[i] = 1.0
            o = np.concatenate([self._state, oh])
            out.append((o - o.mean()) / (o.std() + 1e-8))
        return np.stack(out)

    def close(self) -> None:
        self.env.close()


def make_mamujoco(env_args: dict) -> MAMuJoCoEnv:
    return MAMuJoCoEnv(env_args)
