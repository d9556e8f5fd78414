"""Google Research Football adapter, stepped on the host (counterpart of
``harl_tpu/envs/football/football_env.py``); needs the gfootball C++ engine.

Parity target: ``harl/envs/football/football_env.py`` — builds the
115 + 11·(n−1)-dim global state following the Simple115 wrapper
(football_env.py:81-130) and exposes the HARL 6-tuple protocol. The gfootball
engine is an external dependency; when it is not installed this adapter
raises an informative error at construction.
"""
from __future__ import annotations

import numpy as np

from harl_tpu_torch.utils import spaces


class FootballEnv:
    is_jax = False

    def __init__(self, env_args: dict):
        try:
            import gfootball.env as football_env
        except ImportError as e:
            raise ImportError(
                "Google Research Football requires the `gfootball` package "
                "(C++ engine). Install it to use --env football; see the "
                "reference adapter harl/envs/football/football_env.py for the "
                "expected scenario configuration."
            ) from e
        self.env_name = env_args.get("env_name", "academy_3_vs_1_with_keeper")
        self.n_agents = env_args.get("number_of_left_players_agent_controls", 3)
        self.env = football_env.create_environment(
            env_name=self.env_name,
            number_of_left_players_agent_controls=self.n_agents,
            representation=env_args.get("representation", "simple115v2"),
        )
        obs_dim = 115
        state_dim = 115 + 11 * (self.n_agents - 1)
        self.observation_space = [spaces.Box.create(-np.inf, np.inf, obs_dim)] * self.n_agents
        self.share_observation_space = [spaces.Box.create(-np.inf, np.inf, state_dim)] * self.n_agents
        self.action_space = [spaces.Discrete(19)] * self.n_agents
        self._last_obs = None

    def seed(self, seed):
        pass  # gfootball seeds via env creation

    def _state(self, obs):
        """Global state: obs[0] ⊕ other agents' player-specific blocks
        (football_env.py:81-130 structure)."""
        extras = [obs[i][:11] for i in range(1, self.n_agents)]
        return np.concatenate([obs[0]] + extras).astype(np.float32)

    def reset(self):
        obs = np.asarray(self.env.reset(), np.float32)
        self._last_obs = obs
        return obs, self._state(obs), np.ones((self.n_agents, 19), np.float32)

    def step(self, actions):
        acts = [int(np.asarray(a).reshape(-1)[0]) for a in actions]
        obs, reward, done, info = self.env.step(acts)
        obs = np.asarray(obs, np.float32)
        reward = np.asarray(reward, np.float32).reshape(self.n_agents, 1)
        dones = np.full((self.n_agents,), bool(done))
        infos = [{"bad_transition": False, "score_reward": info.get("score_reward", 0)}
                 for _ in range(self.n_agents)]
        return obs, self._state(obs), reward, dones, infos, np.ones((self.n_agents, 19), np.float32)

    def close(self):
        self.env.close()
