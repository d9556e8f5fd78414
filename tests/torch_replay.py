"""Replays the JAX package's random draws into the port.

The JAX runner derives every draw from PRNG keys; the port takes its draws
from a noise source (``harl_tpu_torch/utils/noise.py``). ``ReplayNoise``
hands out precomputed draws in the order the port asks for them, and the
functions below re-derive the JAX draws from the same keys.
"""
from collections import deque

import jax
import jax.numpy as jnp
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


def soccer_reset_noise(reset_keys, n_agents, n_defenders):
    """The academy soccer reset's three normal draws (soccer.py:145-153):
    the attackers' x, their y and the outfield defenders' x."""
    def one(k):
        k1, k2, k3 = jax.random.split(k, 3)
        return (jax.random.normal(k1, (n_agents,)), jax.random.normal(k2, (n_agents,)),
                jax.random.normal(k3, (n_defenders - 1,)))

    return tuple(np.asarray(x) for x in jax.vmap(one)(reset_keys))


def aircombat_reset_noise(reset_keys, n_allies, n_enemies):
    """The air-combat reset's three normal draws (aircombat.py:122-131):
    the allies' x, the enemies' x and every aircraft's altitude."""
    def one(k):
        ka, ke, kv = jax.random.split(k, 3)
        return (jax.random.normal(ka, (n_allies,)), jax.random.normal(ke, (n_enemies,)),
                jax.random.normal(kv, (n_allies + n_enemies,)))

    return tuple(np.asarray(x) for x in jax.vmap(one)(reset_keys))


def swimmer_reset_noise(reset_keys, n_links):
    """The swimmer reset's two uniform draws (swimmer.py:145-151): the link
    angles' and the velocities'."""
    def one(k):
        k1, k2 = jax.random.split(k)
        return jax.random.uniform(k1, (n_links,)), jax.random.uniform(k2, (n_links + 2,))

    return tuple(np.asarray(x) for x in jax.vmap(one)(reset_keys))


def multi_gumbel_split(key, shapes):
    """The Gumbels of an on-policy MultiDiscrete sample (act.py:86-96): the
    agent's key split once per sub-head, one draw each."""
    return [gumbel_noise(k, sh) for k, sh in zip(jax.random.split(key, len(shapes)), shapes)]


def multi_gumbel_fold_in(key, shapes):
    """The Gumbels of HASAC's MultiDiscrete sample (off_policy_actors.py:
    156-180): sub-head j draws from ``fold_in(key, j)``."""
    return [gumbel_noise(jax.random.fold_in(key, j), sh) for j, sh in enumerate(shapes)]


def _draw(noise, kind, key, shape, high=None):
    """Queue one draw of ``kind`` ("normal", "gumbel", "uniform" or
    "randint" below ``high``) from ``key``."""
    if kind == "normal":
        noise.actions.append(normal(key, shape))
    elif kind == "gumbel":
        noise.gumbels.append(gumbel_noise(key, shape))
    elif kind == "uniform":
        noise.uniforms.append(uniform(key, shape))
    else:
        noise.ints.append((high, randint(key, shape, high)))


def queue_host_rollout(noise, rng, steps, draws):
    """Queue the action draws of ``steps`` steps of the JAX on-policy host
    path (``collect_host`` and ``host_eval``, on_policy.py:658, 774): each
    step splits ``rng`` once and agent i samples from ``fold_in(k, i)``
    (``:289``); the host envs draw nothing. ``draws`` is per agent
    ("normal" or "gumbel", shape). Returns the rng after the steps."""
    for _ in range(steps):
        rng, k = jax.random.split(rng)
        for i, (kind, shape) in enumerate(draws):
            _draw(noise, kind, jax.random.fold_in(k, i), shape)
    return rng


def queue_host_update(noise, rng, n_agents, fixed_order=False):
    """Queue the agent permutation of the update after a host collection,
    from ``rng, k_order, k_update, k_critic = split(rng, 4)``
    (on_policy.py:727); returns (k_update, k_critic) for the minibatch
    shuffles, which one minibatch does not draw."""
    _, k_order, k_update, k_critic = jax.random.split(rng, 4)
    if n_agents > 1 and not fixed_order:
        noise.perms.append(np.asarray(jax.random.permutation(k_order, n_agents)))
    return k_update, k_critic


def queue_host_off_policy_steps(noise, rng, steps, draws):
    """Queue the draws of ``steps`` steps of the JAX off-policy host path
    (``_host_steps``, off_policy.py:825-829): each step splits ``rng``
    three ways and agent i draws from ``fold_in(k1, i)``; ``draws`` is per
    agent (kind, shape[, high]) as ``_draw`` takes them: the warmup's
    "uniform" (Box) or "randint" (Discrete), the exploration "normal" (Box)
    or "gumbel" (HASAC's Discrete). Returns the rng after the steps."""
    for _ in range(steps):
        rng, k1, _ = jax.random.split(rng, 3)
        for i, (kind, shape, *high) in enumerate(draws):
            _draw(noise, kind, jax.random.fold_in(k1, i), shape, *high)
    return rng


def queue_warmup(noise, rng, steps, act_dims, n_envs, dof):
    """Queue the draws of ``steps`` steps of the JAX runner's Box warmup
    (``warmup_block``, off_policy.py:370-385) on ``n_envs`` planar envs of
    ``dof`` degrees of freedom: agent i's uniforms from ``fold_in(k1, i)``,
    the env's reset draws from ``k2``. Returns the rng after the block."""
    rng, k = jax.random.split(rng)
    for kk in jax.random.split(k, steps):
        k1, k2 = jax.random.split(kk)
        for i, d in enumerate(act_dims):
            noise.uniforms.append(uniform(jax.random.fold_in(k1, i), (n_envs, d)))
        noise.resets.append(step_reset_noise(k2, n_envs, dof))
    return rng


def queue_collect(noise, rng, steps, act_dims, n_envs, dof):
    """Queue the draws of a JAX Box collect block of ``steps`` steps
    (``collect_block``, off_policy.py:387-408): agent i's exploration
    normals from ``fold_in(k1, i)``, the reset draws from ``k2``. Returns
    the rng after the block."""
    rng, k = jax.random.split(rng)
    for kk in jax.random.split(k, steps):
        k1, k2 = jax.random.split(kk)
        for i, d in enumerate(act_dims):
            noise.actions.append(normal(jax.random.fold_in(k1, i), (n_envs, d)))
        noise.resets.append(step_reset_noise(k2, n_envs, dof))
    return rng


def queue_train(noise, jr, rng, n_updates, cur_size, batch, total_it=0):
    """Queue the draws of ``n_updates`` updates of the JAX runner ``jr``'s
    ``train_block`` (Box actions, off_policy.py:410-491), each from
    ``split(rng, 5)``: the replay starts over ``cur_size`` rows, the
    next-action or target smoothing normals, and on a policy step HASAC's
    initial-action normals (``fold_in(k_actor, 100 + i)``), the agent
    permutation and HASAC's agent normals in update order. ``total_it``
    is the update count before the first. Returns the rng after them."""
    act_dims, N = [sp.shape[0] for sp in jr.act_spaces], jr.n_agents
    for _ in range(n_updates):
        rng, k_sample, k_next, k_actor, k_order = jax.random.split(rng, 5)
        noise.starts.append((cur_size, np.asarray(
            jax.random.randint(k_sample, (batch,), 0, jnp.int32(cur_size)))))
        if jr.algo in ("hasac", "hatd3", "matd3"):
            for i, d in enumerate(act_dims):
                noise.actions.append(normal(jax.random.fold_in(k_next, i), (batch, d)))
        total_it += 1
        if total_it % jr.policy_freq:
            continue
        if jr.algo == "hasac":
            for i, d in enumerate(act_dims):
                noise.actions.append(normal(jax.random.fold_in(k_actor, 100 + i), (batch, d)))
        order = range(N)
        if jr.algo not in ("maddpg", "matd3") and not jr.fixed_order:
            order = np.asarray(jax.random.permutation(k_order, N))
            noise.perms.append(order)
        if jr.algo == "hasac":
            for i in order:
                noise.actions.append(normal(jax.random.fold_in(k_actor, int(i)),
                                            (batch, act_dims[i])))
    return rng


def late_state(state, count=None, log_alpha=None):
    """The JAX runner's off-policy ``state`` with every ``optax.adam``
    count (the networks', and α's) set to ``count`` and every log α (each
    agent's and the critic's) to ``log_alpha``, where not None: what a long
    run reaches, set in place of running it."""
    def visit(x):
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            f = {k: visit(v) for k, v in x._asdict().items()}
            if count is not None and {"count", "mu", "nu"} <= set(f):
                f["count"] = jnp.asarray(count, jnp.int32)
            if log_alpha is not None and f.get("log_alpha") is not None:
                f["log_alpha"] = jnp.asarray(log_alpha, jnp.float32)
            return type(x)(**f)
        if isinstance(x, (tuple, list)):
            return type(x)(visit(v) for v in x)
        return x

    return visit(state)


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
