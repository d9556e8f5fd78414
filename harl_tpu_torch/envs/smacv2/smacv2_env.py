"""Real-binary SMACv2 adapter, stepped on the host (counterpart of
``harl_tpu/envs/smacv2/smacv2_env.py``); needs the StarCraft II binary and
the ``smacv2`` package.

Parity target: ``harl/envs/smacv2/smacv2_env.py`` — wraps
``StarCraftCapabilityEnvWrapper`` with the per-map capability-distribution
config yaml. The repo ships the reference's 15 map-config yamls under
``harl_tpu_torch/configs/envs_cfgs/smacv2_map_config/`` (byte copies of the
JAX package's); this adapter feeds them to the real binary. Without the
package/binary the pure-tensor SMACLite capability analogue
(envs/smaclite, smacv2_* map names) trains the same map distributions.
"""
from __future__ import annotations

import os

import numpy as np

from harl_tpu_torch.utils import spaces

_MAP_CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    os.pardir, "configs", "envs_cfgs", "smacv2_map_config")


def load_map_config(map_name: str) -> dict:
    import yaml

    path = os.path.join(os.path.abspath(_MAP_CONFIG_DIR), f"{map_name}.yaml")
    with open(path, encoding="utf-8") as f:
        cfg = yaml.safe_load(f)
    return cfg


class SMACv2Env:
    is_jax = False
    metric_keys = ("won", "dead_allies", "dead_enemies")

    def __init__(self, env_args: dict):
        try:
            from smacv2.env.starcraft2.wrapper import (
                StarCraftCapabilityEnvWrapper,
            )
        except ImportError as e:
            raise ImportError(
                "Real-binary SMACv2 requires the `smacv2` package and the "
                "StarCraft II game binary (SC2PATH). Install both to use "
                "--env smacv2 with backend=native; without them the pure-tensor "
                "SMACLite capability analogue trains the same map configs."
            ) from e
        self._wrapper_cls = StarCraftCapabilityEnvWrapper
        self.map_config = load_map_config(env_args.get("map_name",
                                                       "protoss_5_vs_5"))
        # the reference constructs the wrapper inside seed() so each rank
        # gets its own SC2 process with its own seed (smacv2_env.py:48-63)
        self._build(env_args.get("seed", 1))

    def _build(self, seed):
        self.env = self._wrapper_cls(seed=seed, **self.map_config)
        info = self.env.get_env_info()
        self.n_agents = info["n_agents"]
        self.n_actions = info["n_actions"]
        self.observation_space = [
            spaces.Box.create(-np.inf, np.inf, info["obs_shape"])
        ] * self.n_agents
        self.share_observation_space = [
            spaces.Box.create(-np.inf, np.inf, info["state_shape"])
        ] * self.n_agents
        self.action_space = [spaces.Discrete(self.n_actions)] * self.n_agents
        self._timeouts = self.env.env.timeouts

    def seed(self, seed):
        self._build(seed)

    def reset(self):
        self.env.reset()
        obs = np.asarray(self.env.get_obs(), np.float32)
        state = np.tile(
            np.asarray(self.env.get_state(), np.float32), (self.n_agents, 1))
        avail = np.asarray(self.env.get_avail_actions(), np.float32)
        return obs, state, avail

    def step(self, actions):
        acts = [int(np.asarray(a).reshape(-1)[0]) for a in actions]
        reward, terminated, info = self.env.step(acts)
        obs = np.asarray(self.env.get_obs(), np.float32)
        state = np.tile(
            np.asarray(self.env.get_state(), np.float32), (self.n_agents, 1))
        rewards = np.full((self.n_agents, 1), reward, np.float32)
        dones = np.full((self.n_agents,), bool(terminated))
        if terminated and self.env.env.timeouts > self._timeouts:
            info["bad_transition"] = True
            self._timeouts = self.env.env.timeouts
        infos = [dict(info) for _ in range(self.n_agents)]
        avail = np.asarray(self.env.get_avail_actions(), np.float32)
        return obs, state, rewards, dones, infos, avail

    def close(self):
        self.env.close()


def make_smacv2(env_args: dict) -> SMACv2Env:
    return SMACv2Env(env_args)
