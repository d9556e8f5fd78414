"""Real-binary Bi-DexterousHands adapter, stepped on the host (counterpart
of ``harl_tpu/envs/dexhands/dexhands_env.py``); needs NVIDIA IsaacGym and the
``bidexhands`` package.

Parity target: ``harl/envs/dexhands/dexhands_env.py`` — IsaacGym tasks are
inherently BATCHED (one GPU sim holds all ``n_threads`` envs, the
"always-done" pattern the dexhands logger special-cases), so unlike the
per-env gfootball/LAG adapters this adapter exposes the already-vectorized
protocol: reset()/step() carry a leading ``n_envs`` axis and the runner must
treat it as a pre-vectorized host env (``is_vec = True``). IsaacGym is
CUDA-only; construction without it raises an informative error, and
training uses the pure-tensor dexhands analogue (envs/dexhands_jax, 25
tasks) instead. IsaacGym must be imported before torch, so a process that
uses it imports ``isaacgym`` before ``harl_tpu_torch``.
"""
from __future__ import annotations

import numpy as np


class DexHandsEnv:
    is_jax = False
    is_vec = True  # one batched IsaacGym sim holds all n_threads envs
    metric_keys = ()

    def __init__(self, env_args: dict):
        try:
            import isaacgym  # noqa: F401  (must import before torch)
            from bidexhands.utils.config import (
                get_args, load_env_cfg, parse_sim_params,
            )
            from bidexhands.utils.process_marl import get_AgentIndex
            from bidexhands.utils.parse_task import parse_task
        except ImportError as e:
            raise ImportError(
                "Real Bi-DexterousHands requires NVIDIA IsaacGym (CUDA) and "
                "the `bidexhands` package. Install both to use --env "
                "dexhands with backend=native; without them the pure-tensor "
                "dexhands analogue (--env dexhands_jax) provides the same "
                "task family."
            ) from e
        import torch

        self._torch = torch
        args = get_args(env_args)
        cfg = load_env_cfg(args)
        sim_params = parse_sim_params(args, cfg)
        agent_index = get_AgentIndex(cfg)
        args.task_type = "MultiAgent"
        self.env = parse_task(args, cfg, sim_params, agent_index)
        self.n_envs = env_args["n_threads"]
        self.n_agents = self.env.num_agents
        self.share_observation_space = self.env.share_observation_space
        self.observation_space = self.env.observation_space
        self.action_space = self.env.action_space

    def _t2n(self, x):
        return x.detach().cpu().numpy()

    def seed(self, seed):
        pass  # IsaacGym seeds via its sim config

    def reset(self):
        obs, s_obs, _ = self.env.reset()
        return self._t2n(obs), self._t2n(s_obs), [None] * self.n_envs

    def step(self, actions):
        """actions: (n_envs, n_agents, act_dim) → batched 6-tuple (dexhands
        auto-resets internally; dexhands_env.py:29-39)."""
        acts = self._torch.tensor(np.asarray(actions).transpose(1, 0, 2))
        obs, state, rew, done, _info, _ = self.env.step(acts)
        infos = [[{} for _ in range(self.n_agents)] for _ in range(self.n_envs)]
        return (self._t2n(obs), self._t2n(state), self._t2n(rew),
                self._t2n(done), infos, [None] * self.n_envs)

    def close(self):
        pass


def make_dexhands(env_args: dict) -> DexHandsEnv:
    return DexHandsEnv(env_args)
