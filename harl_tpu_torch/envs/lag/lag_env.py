"""Light Aircraft Game (LAG / CloseAirCombat) host adapter (counterpart of
``harl_tpu/envs/lag/lag_env.py``).

Parity target: ``harl/envs/lag/lag_env.py:1-69`` — a thin wrapper mapping the
JSBSim env family (SingleControl / SingleCombat / MultipleCombat, each
parameterized by a task name) onto the 6-tuple step protocol:

  reset() -> (obs, share_obs, avail)    step() -> (obs, share_obs, rew,
  dones, infos, avail)

Single-agent control tasks expose obs as share_obs and wrap reward/done/info
into per-agent lists; multi-agent combat tasks pass the env's own share_obs
through and squeeze the done matrix — exactly the reference's branches.

The JSBSim flight-dynamics engine + the CloseAirCombat env package are
external dependencies (the reference vendors the latter under
``harl/envs/lag/JSBSim``). This adapter imports them from the environment
(pip-installed ``LAG``/CloseAirCombat checkout on PYTHONPATH) and raises an
informative error when absent. The pure-tensor analogue that needs no
external engine is ``envs/lag_jax/aircombat.py`` (``--env lag_jax``).
"""
from __future__ import annotations

import numpy as np


def _import_env_family():
    """Locate the CloseAirCombat env classes under their common import paths."""
    candidates = (
        "envs.JSBSim.envs",          # running inside a CloseAirCombat checkout
        "closeaircombat.envs",       # pip-style install
        "LAG.envs.JSBSim.envs",
    )
    errs = []
    for mod in candidates:
        try:
            m = __import__(mod, fromlist=[
                "SingleCombatEnv", "SingleControlEnv", "MultipleCombatEnv"
            ])
            return m.SingleCombatEnv, m.SingleControlEnv, m.MultipleCombatEnv
        except ImportError as e:  # try the next spelling
            errs.append(f"{mod}: {e}")
    raise ImportError(
        "LAG/CloseAirCombat env package not found (tried "
        + "; ".join(errs)
        + "). Install JSBSim + the CloseAirCombat repo "
        "(https://github.com/liuqh16/CloseAirCombat) or use the pure-tensor "
        "analogue: --env lag_jax."
    )


class LAGEnv:
    is_jax = False

    def __init__(self, env_args: dict):
        SingleCombatEnv, SingleControlEnv, MultipleCombatEnv = _import_env_family()
        self.env_args = env_args
        scenario = env_args.get("scenario", "MultipleCombat")
        task = env_args["task"]
        if scenario == "SingleCombat":
            self.env = SingleCombatEnv(task)
        elif scenario == "SingleControl":
            self.env = SingleControlEnv(task)
        elif scenario == "MultipleCombat":
            self.env = MultipleCombatEnv(task)
        else:
            raise ValueError(f"unknown LAG scenario {scenario!r}")
        self.n_agents = self.env.num_agents
        if self.n_agents == 1:
            self.share_observation_space = [self.env.observation_space]
            self.observation_space = [self.env.observation_space]
            self.action_space = [self.env.action_space]
        else:
            self.share_observation_space = self._repeat(self.env.share_observation_space)
            self.observation_space = self._repeat(self.env.observation_space)
            self.action_space = self._repeat(self.env.action_space)

    # ------------------------------------------------------------- protocol
    def reset(self):
        if self.n_agents == 1:
            obs = self.env.reset()
            return obs, obs, None
        obs, share_obs = self.env.reset()
        return obs, share_obs, None

    def step(self, actions):
        if self.n_agents == 1:
            obs, reward, done, info = self.env.step(actions)
            return obs, obs, reward, done[0], [info], None
        obs, share_obs, reward, done, info = self.env.step(actions)
        return obs, share_obs, reward, np.squeeze(done), self._repeat(info), None

    def seed(self, seed):
        pass  # JSBSim tasks seed internally (reference :47-48)

    def render(self):
        # the sim writes tacview-compatible flight logs instead of pixels
        self.env.render(mode="txt", filepath="render.txt.acmi")

    def close(self):
        self.env.close()

    def _repeat(self, a):
        return [a for _ in range(self.n_agents)]
