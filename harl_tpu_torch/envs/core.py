"""Batched environment protocol (counterpart of ``harl_tpu/envs/core.py``).

An environment steps a whole batch of instances at once; the JAX package's
``vmap`` becomes an explicit leading batch dimension X. Its state is a
NamedTuple of tensors with X first, and

    env.reset(noise)             -> (state, TimeStep)
    env.step(state, actions)     -> (state, TimeStep)

where ``noise`` is the tuple of tensors that ``env.reset_noise_spec`` asks
of the noise source (``utils/noise.py``): the reset's draws, made by the
caller so that a test can hand in the JAX package's.

``auto_reset_step`` keeps the JAX semantics (core.py:49-78): a fresh reset
state is drawn for EVERY env on EVERY step and selected with ``where`` where
the env finished, so the returned obs/state/availability start a new episode
while rewards/dones/bad_transition/metrics describe the finishing step.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch


class TimeStep(NamedTuple):
    obs: torch.Tensor                # (X, n_agents, obs_dim)
    share_obs: torch.Tensor          # (X, share_obs_dim) — EP state
    rewards: torch.Tensor            # (X, n_agents, 1)
    dones: torch.Tensor              # (X, n_agents) bool
    bad_transition: torch.Tensor     # (X,) bool — truncation flag
    available_actions: Optional[torch.Tensor] = None  # (X, n_agents, n_actions)
    agent_state: Optional[torch.Tensor] = None        # (X, n_agents, ds_fp) — FP state
    metrics: Optional[Dict[str, torch.Tensor]] = None  # per env, e.g. {"won": (X,)}


def linspace32(start: float, stop: float, n: int) -> np.ndarray:
    """``jnp.linspace(start, stop, n)``'s float32 form start·(1 − t) + stop·t
    with t = i·(1/(n − 1)), the endpoint exact. The JAX envs' jitted
    ``jnp.linspace`` equals it for short lines (up to 7 points from ±1000)
    and differs by an ulp or two here and there in longer ones."""
    f = np.float32
    if n == 1:
        return np.array([start], np.float32)
    t = np.arange(n - 1, dtype=np.float32) * (f(1) / f(n - 1))
    return np.append(f(start) * (f(1) - t) + f(stop) * t, f(stop)).astype(np.float32)


class Transition(NamedTuple):
    """``ts`` is post-reset where done, ``final`` the pre-reset timestep."""

    state: Any
    ts: TimeStep
    final: TimeStep


def _where_done(done_env: torch.Tensor, reset: Optional[torch.Tensor],
                cont: Optional[torch.Tensor]):
    if cont is None:
        return None
    return torch.where(done_env.reshape((-1,) + (1,) * (cont.dim() - 1)), reset, cont)


def auto_reset_step(env, state, actions: torch.Tensor, reset_noise) -> Transition:
    """Step, then reset where all agents of an env are done."""
    next_state, ts = env.step(state, actions)
    done_env = ts.dones.all(dim=1)
    reset_state, reset_ts = env.reset(reset_noise)
    new_state = type(next_state)(
        *(_where_done(done_env, r, c) for r, c in zip(reset_state, next_state)))
    post = ts._replace(**{
        k: _where_done(done_env, getattr(reset_ts, k), getattr(ts, k))
        for k in ("obs", "share_obs", "available_actions", "agent_state")})
    return Transition(new_state, post, ts)


class VecEnv:
    """A batch of ``n_envs`` instances of ``env`` on one device."""

    def __init__(self, env, n_envs: int):
        self.env = env
        self.n_envs = n_envs
        self.n_agents = env.n_agents
        self.observation_space = env.observation_space
        self.share_observation_space = env.share_observation_space
        self.action_space = env.action_space

    def reset(self, noise) -> Tuple[Any, TimeStep]:
        return self.env.reset(noise.reset_noise(self.n_envs, self.env.reset_noise_spec))

    def step(self, state, actions: torch.Tensor, noise) -> Transition:
        return auto_reset_step(
            self.env, state, actions,
            noise.reset_noise(self.n_envs, self.env.reset_noise_spec))
