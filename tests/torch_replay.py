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


def reset_noise(reset_keys, dof, qvel_normal=True):
    """(uniform [0, 1), standard normal or uniform [0, 1)), each (n, dof),
    as the planar env's ``reset(key)`` draws them (planar.py:647-659): the
    cheetah's qvel is normal, Walker2d's and Hopper's uniform."""
    def one(key):
        k1, k2 = jax.random.split(key)
        second = jax.random.normal if qvel_normal else jax.random.uniform
        return jax.random.uniform(k1, (dof,)), second(k2, (dof,))

    u, n = jax.vmap(one)(reset_keys)
    return np.asarray(u), np.asarray(n)


def _step_reset_keys(k_env, n_envs):
    """The reset keys of one ``VecEnv.step(…, k_env)``: each env splits its
    key into (step, reset) (core.py:49-54)."""
    keys = jax.random.split(k_env, n_envs)
    return jax.vmap(lambda k: jax.random.split(k)[1])(keys)


def step_reset_noise(k_env, n_envs, dof, qvel_normal=True):
    """The planar reset draws of one ``VecEnv.step(…, k_env)``."""
    return reset_noise(_step_reset_keys(k_env, n_envs), dof, qvel_normal)


def mpe_reset_noise(reset_keys, n_agents, goals, n_landmarks=3):
    """The MPE reset's draws (mpe.py:176-195) as the port's tuple: the
    agents' uniforms (n, 2·n_agents), the landmarks' (n, 2·n_landmarks)
    and, where the scenario draws goals, the ``randint`` goal indices
    (n, n_agents) as integers."""
    def one(key):
        k1, k2, k3 = jax.random.split(key, 3)
        return (jax.random.uniform(k1, (n_agents, 2)).ravel(),
                jax.random.uniform(k2, (n_landmarks, 2)).ravel(),
                jax.random.randint(k3, (n_agents,), 0, n_landmarks))

    ua, ul, g = (np.asarray(x) for x in jax.vmap(one)(reset_keys))
    return (ua, ul, g) if goals else (ua, ul)


def step_mpe_reset_noise(k_env, n_envs, n_agents, goals):
    """The MPE reset draws of one ``VecEnv.step(…, k_env)``."""
    return mpe_reset_noise(_step_reset_keys(k_env, n_envs), n_agents, goals)


def smaclite_reset_noise(reset_keys, n_allies, n_enemies):
    """The SMACLite reset's spawn draws as the port's (uniform, normal)
    pair of tensors, each (n, 2A+2E): each env splits its key four ways and
    draws the allies' uniforms from the first, the enemies' from the second
    (smaclite.py:405, 459-462). The normal half is not read: zeros."""
    def one(key):
        k1, k2, _, _ = jax.random.split(key, 4)
        return jax.numpy.concatenate([jax.random.uniform(k1, (n_allies, 2)).ravel(),
                                      jax.random.uniform(k2, (n_enemies, 2)).ravel()])

    u = np.asarray(jax.vmap(one)(reset_keys))
    return torch.from_numpy(np.array(u)), torch.zeros(u.shape)


def step_smaclite_reset_noise(k_env, n_envs, n_allies, n_enemies):
    """The SMACLite reset draws of one ``VecEnv.step(…, k_env)``."""
    return smaclite_reset_noise(_step_reset_keys(k_env, n_envs), n_allies, n_enemies)


def smacv2_reset_noise(reset_keys, n_allies, n_enemies):
    """A SMACv2 reset's draws (smaclite.py:404-453) as the port's nine
    tensors (its ``reset_noise_spec``): each env splits its key four ways, draws
    the ally and enemy types' uniforms from the third and fourth
    (``jax.random.choice``), and splits the first six ways (ks, kr1, kr2,
    kr3, kr4, kang) for the spawn coin, the reflected allies (kr1), the
    reflected enemies' y (kr2) and x jitter (kr3), the surrounded allies'
    normals (kr1 again), the ring's angles (kang) and radii (kr4)."""
    A, E = n_allies, n_enemies

    def one(key):
        k1, _, k3, k4 = jax.random.split(key, 4)
        ks, kr1, kr2, kr3, kr4, kang = jax.random.split(k1, 6)
        u = jax.random.uniform
        return (u(k3, (A,)), u(k4, (E,)), u(ks, (1,)), u(kr1, (A, 2)).ravel(), u(kr2, (E,)),
                u(kr3, (E,)), jax.random.normal(kr1, (A, 2)).ravel(), u(kang, (E,)),
                u(kr4, (E,)))

    return tuple(torch.from_numpy(np.array(x)) for x in jax.vmap(one)(reset_keys))


def step_smacv2_reset_noise(k_env, n_envs, n_allies, n_enemies):
    """The SMACv2 reset draws of one ``VecEnv.step(…, k_env)``."""
    return smacv2_reset_noise(_step_reset_keys(k_env, n_envs), n_allies, n_enemies)


def humanoid_reset_noise(reset_keys, dof=23):
    """The Humanoid reset's draws (humanoid.py:384-393) as the port's two
    uniforms on [0, 1), each (n, 23): each env splits its key in two."""
    def one(key):
        k1, k2 = jax.random.split(key)
        return jax.random.uniform(k1, (dof,)), jax.random.uniform(k2, (dof,))

    return tuple(np.asarray(x) for x in jax.vmap(one)(reset_keys))


def handover_reset_noise(reset_keys, n_objects, n_layouts):
    """The dexhands catch reset's draws (handover.py:375-410) as the port's
    five: each env splits its key five ways for the layout (``randint``, as
    (n, 1) integers), the object and goal position normals, the goal axis
    normals (each (n, 3·n_obj)) and the goal angle's uniforms on [0, 1)."""
    def one(key):
        k0, k1, k2, k3, k4 = jax.random.split(key, 5)
        return (jax.random.randint(k0, (1,), 0, n_layouts),
                *(jax.random.normal(k, (n_objects, 3)).ravel() for k in (k1, k2, k3)),
                jax.random.uniform(k4, (n_objects,)))

    return tuple(np.asarray(x) for x in jax.vmap(one)(reset_keys))


def manip_reset_noise(reset_keys, width):
    """The dexhands manipulation reset's one normal draw (manip.py:296-315),
    (n, 1) for a hinge angle or (n, 3·n_obj) for the table objects: each env
    splits its key in two and draws from the first."""
    shape = () if width == 1 else (width // 3, 3)
    return (np.asarray(jax.vmap(lambda k: jax.random.normal(
        jax.random.split(k)[0], shape).reshape(width))(reset_keys)),)


def env_reset_noise(env, reset_keys):
    """The JAX draws of ``env``'s reset (a port env) for any env that states
    them in a form above, by its ``reset_noise_spec``."""
    spec = env.reset_noise_spec
    if spec[0][0] == "randint" and len(spec) == 5:
        return handover_reset_noise(reset_keys, spec[-1][1], spec[0][2])
    if len(spec) == 1:
        return manip_reset_noise(reset_keys, spec[0][1])
    if spec == (("uniform", 23), ("uniform", 23)):
        return humanoid_reset_noise(reset_keys)
    raise ValueError(f"no replay of the reset draws {spec}")


def gumbel_noise(key, shape):
    """The standard Gumbel draw of ``jax.random.categorical(key, logits)``
    with logits of ``shape`` (argmax(gumbel + logits), jax 0.9)."""
    return np.asarray(jax.random.gumbel(key, shape))


def uniform(key, shape):
    """``jax.random.uniform(key, shape)`` on [0, 1): the bits of a draw
    with other bounds (the port scales it as JAX does)."""
    return np.asarray(jax.random.uniform(key, shape))


def normal(key, shape):
    return np.asarray(jax.random.normal(key, shape))


def randint(key, shape, high):
    """``jax.random.randint(key, shape, 0, high)``, as integers."""
    return np.asarray(jax.random.randint(key, shape, 0, high))


class ReplayNoise:
    """A noise source that hands out queued draws, raising if the port asks
    for something other than what was queued."""

    def __init__(self):
        self.actions, self.gumbels, self.resets, self.perms = deque(), deque(), deque(), deque()
        self.uniforms, self.starts, self.ints = deque(), deque(), deque()

    def action_noise(self, shape):
        a = self.actions.popleft()
        assert a.shape == tuple(shape), (a.shape, tuple(shape))
        return torch.from_numpy(np.array(a))

    def gumbel_noise(self, shape):
        g = self.gumbels.popleft()
        assert g.shape == tuple(shape), (g.shape, tuple(shape))
        return torch.from_numpy(np.array(g))

    def reset_noise(self, n_envs, spec):
        draws = self.resets.popleft()
        assert [tuple(x.shape) for x in draws] == [(n_envs, w) for _, w, *_ in spec], (
            [x.shape for x in draws], spec)
        return tuple(torch.as_tensor(np.array(x)) for x in draws)

    def permutation(self, n):
        p = self.perms.popleft()
        assert p.shape == (n,), (p.shape, n)
        return torch.from_numpy(np.array(p)).long()

    def uniform(self, shape):
        u = self.uniforms.popleft()
        assert u.shape == tuple(shape), (u.shape, tuple(shape))
        return torch.from_numpy(np.array(u))

    def indices(self, n, high):
        high_q, idx = self.starts.popleft()
        assert (idx.shape, high_q) == ((n,), high), (idx.shape, high_q, n, high)
        return torch.from_numpy(np.array(idx)).long()

    def randint(self, shape, high):
        high_q, a = self.ints.popleft()
        assert (a.shape, high_q) == (tuple(shape), high), (a.shape, high_q, shape, high)
        return torch.from_numpy(np.array(a)).long()

    def drained(self):
        return not (self.actions or self.gumbels or self.resets or self.perms
                    or self.uniforms or self.starts or self.ints)
