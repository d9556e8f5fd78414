"""Replays the JAX package's random draws into the port.

The JAX runner derives every draw from PRNG keys; the port takes its draws
from a noise source (``harl_tpu_torch/utils/noise.py``). ``ReplayNoise``
hands out precomputed draws in the order the port asks for them, and the
functions below re-derive the JAX draws from the same keys.
"""
from collections import deque

import jax
import numpy as np
import torch


def reset_noise(reset_keys, dof):
    """(uniform [0, 1), standard normal), each (n, dof), as the planar
    env's ``reset(key)`` draws them (planar.py:647-659)."""
    def one(key):
        k1, k2 = jax.random.split(key)
        return jax.random.uniform(k1, (dof,)), jax.random.normal(k2, (dof,))

    u, n = jax.vmap(one)(reset_keys)
    return np.asarray(u), np.asarray(n)


def step_reset_noise(k_env, n_envs, dof):
    """The reset draws of one ``VecEnv.step(…, k_env)``: each env splits
    its key into (step, reset) (core.py:49-54)."""
    keys = jax.random.split(k_env, n_envs)
    reset_keys = jax.vmap(lambda k: jax.random.split(k)[1])(keys)
    return reset_noise(reset_keys, dof)


class ReplayNoise:
    """A noise source that hands out queued draws, raising if the port asks
    for something other than what was queued."""

    def __init__(self):
        self.actions, self.resets, self.perms = deque(), deque(), deque()

    def action_noise(self, shape):
        a = self.actions.popleft()
        assert a.shape == tuple(shape), (a.shape, tuple(shape))
        return torch.from_numpy(np.array(a))

    def reset_noise(self, n_envs, dof):
        u, n = self.resets.popleft()
        assert u.shape == (n_envs, dof)
        return torch.from_numpy(np.array(u)), torch.from_numpy(np.array(n))

    def permutation(self, n):
        p = self.perms.popleft()
        assert p.shape == (n,), (p.shape, n)
        return torch.from_numpy(np.array(p)).long()

    def drained(self):
        return not (self.actions or self.resets or self.perms)
