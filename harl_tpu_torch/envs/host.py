"""Host-side vectorized environment for simulators that step in NumPy
(counterpart of ``harl_tpu/envs/host.py``; reference
``harl/envs/env_wrappers.py:220-366``).

The env families whose physics runs in an external engine (MuJoCo through
gymnasium, StarCraft II, gfootball, JSBSim, gym tasks) step on the host,
while the policies and the update run on the runner's device. Auto-reset
follows the reference's ``shareworker`` loop (env_wrappers.py:166-217): when
an env reports all-done it is reset and the FRESH obs replaces the terminal
one, with the terminal obs returned apart (``final_obs``,
``final_share_obs``) for the off-policy next-obs bookkeeping.

A host env implements the reference's 6-tuple protocol (README.md:186-208):

    reset() -> (obs, share_obs, available_actions)
    step(actions) -> (obs, share_obs, rewards, dones, infos, available_actions)

with the attributes ``n_agents``, ``observation_space``,
``share_observation_space``, ``action_space`` and, where it has one,
``seed(int)``. ``HostVecEnv`` hands NumPy arrays to the runner, which moves
them to its device.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np


class HostVecEnv:
    """``len(env_fns)`` host envs stepped together; env i is seeded with
    ``seed + 1000·i`` (the reference's per-rank seeds, envs_tools.py:99).
    A runner handed one (``env=``) uses it whole, as it uses the native
    engine: ``ensure_envs`` reseeds it."""

    is_jax = False
    is_vectorized = True

    def __init__(self, env_fns, seed: int = 1):
        self.envs = [fn() for fn in env_fns]
        self.n_envs = len(self.envs)
        e = self.envs[0]
        self.n_agents = e.n_agents
        self.observation_space = e.observation_space
        self.share_observation_space = e.share_observation_space
        self.action_space = e.action_space
        self._seed(seed)
        # Each env steps and resets on a thread pool, so engines that release
        # the GIL (MuJoCo, gfootball's C++, JSBSim, SC2's RPC) overlap: the
        # threaded form of the reference's subprocess workers. Each env is
        # touched by one task per call; the pool is capped at 4× the cores.
        self._pool = (
            ThreadPoolExecutor(max_workers=min(self.n_envs, (os.cpu_count() or 2) * 4))
            if self.n_envs > 1 else None)

    def _seed(self, seed: int) -> None:
        for i, env in enumerate(self.envs):
            if hasattr(env, "seed"):
                env.seed(seed + i * 1000)

    def ensure_envs(self, n_envs: int, seed: int = 1) -> None:
        """Reseed the envs from ``seed``; they must be ``n_envs``."""
        if n_envs != self.n_envs:
            raise ValueError(f"a HostVecEnv of {self.n_envs} envs cannot run {n_envs}")
        self._seed(seed)

    def _map(self, fn, *iterables):
        if self._pool is None:
            return [fn(*args) for args in zip(*iterables)]
        return list(self._pool.map(fn, *iterables))

    def reset(self):
        results = self._map(lambda env: env.reset(), self.envs)
        obs, share, avail = map(list, zip(*results))
        return np.stack(obs), np.stack(share), None if avail[0] is None else np.stack(avail)

    def step(self, actions: np.ndarray) -> dict:
        """``actions`` (n_envs, n_agents, act_dim) → a dict of stacked float32
        arrays (``dones`` bool, ``infos`` a list over envs) with auto-reset
        applied; ``final_obs``/``final_share_obs`` hold the pre-reset
        observations where an env finished."""

        def step_one(env, act):
            o, s, r, d, info, av = env.step(act)
            f_o, f_s = o, s
            if np.all(d):
                o, s, av = env.reset()
            return o, s, r, d, info, av, f_o, f_s

        results = self._map(step_one, self.envs, list(actions))
        obs, share, rews, dones, infos, avails, final_obs, final_share = map(
            list, zip(*results))
        return dict(
            obs=np.stack(obs).astype(np.float32),
            share_obs=np.stack(share).astype(np.float32),
            rewards=np.stack(rews).astype(np.float32),
            dones=np.stack(dones),
            infos=infos,
            available_actions=None if avails[0] is None
            else np.stack(avails).astype(np.float32),
            final_obs=np.stack(final_obs).astype(np.float32),
            final_share_obs=np.stack(final_share).astype(np.float32),
        )

    def close(self) -> None:
        for env in self.envs:
            if hasattr(env, "close"):
                env.close()
        if self._pool is not None:
            self._pool.shutdown(wait=False)


def vectorize(env, env_name: str, env_args: dict, n_envs: int, seed: int = 1):
    """``n_envs`` host envs for a runner: a pre-vectorized ``env``
    (``is_vectorized``: the native MuJoCo engine, a ``HostVecEnv``) sized
    with ``ensure_envs(n_envs, seed)``, else a ``HostVecEnv`` of ``env`` and
    ``n_envs − 1`` more that ``make_env(env_name, env_args)`` builds
    (on_policy.py:125-135, 745-754)."""
    from harl_tpu_torch.envs import make_env

    if getattr(env, "is_vectorized", False):
        env.ensure_envs(n_envs, seed=seed)
        return env
    return HostVecEnv([lambda: env] + [lambda: make_env(env_name, env_args)] * (n_envs - 1),
                      seed=seed)
