"""Real-binary SMAC adapter, stepped on the host (counterpart of
``harl_tpu/envs/smac/smac_env.py``); needs the StarCraft II binary and the
``smac`` package.

Parity target: ``harl/envs/smac/StarCraft2_Env.py`` (the reference vendors a
full SMAC fork that talks to SC2 over the pysc2 protobuf RPC,
StarCraft2_Env.py:550-556) wrapped in the HARL 6-tuple protocol. Here the
upstream ``smac`` package provides the SC2 client; this adapter translates
its get_obs/get_state/step API into the framework's host-env protocol the
same way the gfootball/LAG adapters do. When the package or binary is
missing, construction raises an informative error; training in this repo
then uses the pure-tensor SMACLite analogue (envs/smaclite) instead.
"""
from __future__ import annotations

import numpy as np

from harl_tpu_torch.utils import spaces


class SMACEnv:
    is_jax = False
    metric_keys = ("won", "dead_allies", "dead_enemies")

    def __init__(self, env_args: dict):
        try:
            from smac.env import StarCraft2Env
        except ImportError as e:
            raise ImportError(
                "Real-binary SMAC requires the `smac` package and the "
                "StarCraft II game binary (SC2PATH). Install both to use "
                "--env smac with backend=native; without them the pure-tensor "
                "SMACLite analogue (--env smaclite) provides the same maps."
            ) from e
        self._env_cls = StarCraft2Env
        self._kwargs = {"map_name": env_args.get("map_name", "3m")}
        for k in ("difficulty", "reward_scale", "state_last_action",
                  "obs_last_action", "seed"):
            if k in env_args:
                self._kwargs[k] = env_args[k]
        self._build()

    def _build(self):
        self.env = self._env_cls(**self._kwargs)
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
        self._timeouts = 0

    def seed(self, seed):
        """Re-seed by rebuilding with the new seed kwarg (the SMACv2-adapter
        pattern): upstream ``smac``'s ``StarCraft2Env.seed()`` takes NO
        argument (it returns the stored seed) — only the reference's vendored
        fork accepts one (StarCraft2_Env.py:2247), so calling
        ``self.env.seed(seed)`` here would TypeError on every HostVecEnv rank
        (envs/host.py seeds each rank at construction)."""
        try:
            self.env.close()
        except Exception:  # not yet launched / already closed
            pass
        self._kwargs["seed"] = seed
        self._build()

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
        # an episode-limit end is a truncation (StarCraft2_Env marks it via
        # its timeouts counter; reference smacv2_env.py:30-37 pattern)
        if terminated and getattr(self.env, "timeouts", 0) > self._timeouts:
            info["bad_transition"] = True
            self._timeouts = self.env.timeouts
        infos = [dict(info) for _ in range(self.n_agents)]
        avail = np.asarray(self.env.get_avail_actions(), np.float32)
        return obs, state, rewards, dones, infos, avail

    def close(self):
        self.env.close()


def make_smac(env_args: dict) -> SMACEnv:
    return SMACEnv(env_args)
