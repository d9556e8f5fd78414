"""Port parity: one full HAPPO ``train_iteration`` on planar HalfCheetah-6x1.

The JAX runner starts from ``init_state(0)``; the port's runner gets the
JAX parameters through ``convert`` and, through a replaying noise source,
the draws the JAX iteration derives from its keys: the splits of
``on_policy.py:395`` and ``:304``, ``fold_in(key, i)`` for the action noise
(``:289``), the reset keys of every env step (``core.py:51``), the agent
permutation (``:619``) and, with several minibatches, each update's
per-epoch shuffles (``happo.py:160``, ``critics.py:119``).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from harl_tpu.ops import returns as jret
from harl_tpu.ops import value_norm as jvn
from harl_tpu.runners.on_policy import OnPolicyRunner as JRunner
from harl_tpu.utils.config_tools import get_defaults_yaml_args as jdefaults
from harl_tpu_torch.runners.on_policy import OnPolicyRunner
from harl_tpu_torch.utils import convert

from tests.torch_replay import ReplayNoise, reset_noise, step_reset_noise

B, T, N, DOF = 8, 8, 6, 9
# The rollout runs the float32 physics free for T·frame_skip = 40 substeps
# (see test_torch_planar.py); values, returns and losses inherit that.
DATA_RTOL, DATA_ATOL = 1e-4, 2e-4
# Parameters after 2 epochs × (6 actors + critic) of Adam steps: a relative
# gradient error e moves a parameter by about lr·e per step.
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
ARGS = {"algo": "happo", "env": "mamujoco_jax", "exp_name": "parity"}


def _configs(use_gae, num_mini_batch, fixed_order, aggregation):
    algo_args, env_args = jdefaults("happo", "mamujoco_jax")
    algo_args["train"].update(n_rollout_threads=B, episode_length=T, num_env_steps=10 ** 6)
    algo_args["model"].update(hidden_sizes=[16, 16])
    algo_args["algo"].update(ppo_epoch=2, critic_epoch=2, use_gae=use_gae,
                             fixed_order=fixed_order, action_aggregation=aggregation,
                             actor_num_mini_batch=num_mini_batch,
                             critic_num_mini_batch=num_mini_batch)
    # episodes of 5 steps: the 8-step rollout truncates and auto-resets
    env_args.update(scenario="HalfCheetah-v2", agent_conf="6x1", episode_limit=5)
    return algo_args, env_args


def _queue_iteration(noise, rng, act_dims, num_mini_batch, epochs, fixed_order):
    """Queue the draws of one JAX ``train_iteration`` from its ``rng``."""
    rng, k_roll, k_order, k_update, k_critic = jax.random.split(rng, 5)
    for k in jax.random.split(k_roll, T):
        k_act, k_env = jax.random.split(k)
        for i, d in enumerate(act_dims):
            noise.actions.append(np.asarray(jax.random.normal(jax.random.fold_in(k_act, i),
                                                              (B, d))))
        noise.resets.append(step_reset_noise(k_env, B, DOF))
    if fixed_order:
        perm = np.arange(N)
    else:
        perm = np.asarray(jax.random.permutation(k_order, N))
        noise.perms.append(perm)
    if num_mini_batch > 1:
        key = k_update
        for _ in perm:
            key, k_up = jax.random.split(key)
            noise.perms.extend(_perms(k_up, epochs))
        noise.perms.extend(_perms(k_critic, epochs))
    return k_roll


def _perms(key, epochs):
    return list(np.asarray(jax.vmap(lambda k: jax.random.permutation(k, T * B))(
        jax.random.split(key, epochs))))


def _jax_rollout_and_returns(jr, js, k_roll):
    """The JAX rollout of ``train_iteration`` and the returns of
    ``update_phase`` (on_policy.py:399-468), computed apart."""
    carry, data = jax.lax.scan(
        lambda c, k: jr.rollout_step(js.actors, js.critic.params, c, k),
        js.carry, jax.random.split(k_roll, T))
    next_value = jr.critic.get_values(js.critic.params, carry.share_obs)
    values = jvn.denormalize(js.value_norm, jnp.concatenate([data["value"], next_value[None]]))
    masks = jnp.concatenate([js.carry.masks[:, 0][None], data["next_masks"]])
    bad = jnp.concatenate([jnp.ones((1, B, 1)), data["next_bad_masks"]])
    if jr.use_gae:
        ret = jret.compute_gae(data["reward"], values, masks, bad, jr.gamma, jr.gae_lambda)
    else:
        ret = jret.compute_discounted_returns(data["reward"], values, masks, bad, values[-1],
                                              jr.gamma)
    return data, ret


def _close(a, b, rtol=DATA_RTOL, atol=DATA_ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _load(net, flax_params, to_state_dict):
    net.load_state_dict(to_state_dict(jax.tree.map(np.asarray, flax_params)))


@pytest.mark.parametrize("use_gae,num_mini_batch,fixed_order,aggregation", [
    (True, 1, False, "prod"),     # the main path's settings
    (False, 2, False, "prod"),    # discounted returns; shuffled minibatches
    (True, 1, True, "mean"),      # fixed agent order; mean ratio aggregation
])
def test_train_iteration_matches_jax(use_gae, num_mini_batch, fixed_order, aggregation):
    algo_args, env_args = _configs(use_gae, num_mini_batch, fixed_order, aggregation)
    jr = JRunner(ARGS, copy.deepcopy(algo_args), copy.deepcopy(env_args))
    js = jr.init_state(0)
    act_dims = [sp.shape[0] for sp in jr.act_spaces]

    noise = ReplayNoise()
    _, k_env, *_ = jax.random.split(jax.random.PRNGKey(0), N + 2)
    noise.resets.append(reset_noise(jax.random.split(k_env, B), DOF))
    tr = OnPolicyRunner(ARGS, algo_args, env_args, device="cpu", noise=noise)
    ts = tr.init_state(0)
    _close(ts.carry.env_state.q, js.carry.env_state.q, 1e-6, 1e-7)
    _close(ts.carry.obs, js.carry.obs, 1e-5, 1e-5)
    for st, jst in zip(ts.actors, js.actors):
        _load(st.net, jst.params, convert.policy_state_dict)
    _load(ts.critic.net, js.critic.params, convert.vnet_state_dict)

    k_roll = _queue_iteration(noise, js.rng, act_dims, num_mini_batch, 2, fixed_order)
    jdata, jreturns = _jax_rollout_and_returns(jr, js, k_roll)
    js2, jm = jr._train_iteration(js)

    seen = {}
    update_phase = tr.update_phase

    def spy(state, data, *last):
        seen["data"] = data
        seen["returns"] = tr.compute_returns(state, data, *last)[0]
        return update_phase(state, data, *last)

    tr.update_phase = spy
    ts, tm = tr.train_iteration(ts)
    assert noise.drained()

    # rollout data and returns
    data = seen["data"]
    for k in ("obs", "share_obs", "masks", "active_masks", "value", "reward", "next_masks",
              "next_bad_masks", "next_active", "emitted_ret", "emitted_cnt"):
        _close(data[k], jdata[k])
    for i in range(N):
        _close(data["actions"][i], jdata["actions"][i])
        _close(data["logp"][i], jdata["logp"][i])
    assert float(data["emitted_cnt"].sum()) == B       # every env truncated once
    assert float((1 - data["next_bad_masks"]).sum()) == B
    _close(seen["returns"], jreturns)

    # per-agent stats, critic stats and the episode bookkeeping
    _close(tm["actor_stats"], jm["actor_stats"])
    for k in ("value_loss", "critic_grad_norm", "mean_step_reward", "dead_ratio",
              "episode_return_sum", "episode_count"):
        _close(tm[k], jm[k])

    # every new parameter, the ValueNorm state and the carry
    for st, jst in zip(ts.actors, js2.actors):
        ref = convert.policy_state_dict(jax.tree.map(np.asarray, jst.params))
        for k, v in st.net.state_dict().items():
            _close(v, ref[k], PARAM_RTOL, PARAM_ATOL)
    ref = convert.vnet_state_dict(jax.tree.map(np.asarray, js2.critic.params))
    for k, v in ts.critic.net.state_dict().items():
        _close(v, ref[k], PARAM_RTOL, PARAM_ATOL)
    for name in ("running_mean", "running_mean_sq", "debiasing_term"):
        _close(getattr(ts.value_norm, name), getattr(js2.value_norm, name))
    _close(ts.carry.obs, js2.carry.obs)
    _close(ts.carry.env_state.qd, js2.carry.env_state.qd)
    _close(ts.carry.ep_ret, js2.carry.ep_ret)
