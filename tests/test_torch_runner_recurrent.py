"""Port parity: one full HAPPO ``train_iteration`` on SMACLite ``3m`` with the
FP state, GRU actors and critic, Discrete heads and availability masks.

The JAX runner starts from ``init_state(0)``; the port's runner gets the JAX
parameters through ``convert`` and, through a replaying noise source, the
draws the JAX iteration derives from its keys: the SMACLite reset draws of
the initial reset and of every env step (each env's key split four ways,
``smaclite.py:405``), the per-agent Gumbel draws of
``jax.random.categorical(fold_in(k_act, i), logits)`` (``on_policy.py:289``),
the agent permutation (``:619``) and, with several minibatches, each update's
per-epoch shuffles of its chunks (``happo.py:160``, ``critics.py:119``).
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
from harl_tpu_torch.utils.config_tools import get_defaults_yaml_args

from tests.torch_replay import (ReplayNoise, gumbel_noise, smaclite_reset_noise,
                                step_smaclite_reset_noise)

B, T, L, N, N_ACT = 6, 10, 5, 3, 9
# the tolerances of the planar iteration (test_torch_runner.py)
DATA_RTOL, DATA_ATOL = 1e-4, 2e-4
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
ARGS = {"algo": "happo", "env": "smaclite", "exp_name": "parity"}


def _configs(chunked, num_mini_batch):
    algo_args, env_args = jdefaults("happo", "smaclite")
    algo_args["train"].update(n_rollout_threads=B, episode_length=T, num_env_steps=10 ** 6)
    algo_args["model"].update(hidden_sizes=[16, 16], use_recurrent_policy=chunked,
                              use_naive_recurrent_policy=not chunked, recurrent_n=1,
                              data_chunk_length=L)
    algo_args["algo"].update(ppo_epoch=2, critic_epoch=2, actor_num_mini_batch=num_mini_batch,
                             critic_num_mini_batch=num_mini_batch)
    # 7-step episodes: the 10-step rollout truncates and resets every env
    env_args.update(map_name="3m", state_type="FP", episode_limit=7)
    return algo_args, env_args


def _perms(key, epochs, rows):
    return list(np.asarray(jax.vmap(lambda k: jax.random.permutation(k, rows))(
        jax.random.split(key, epochs))))


def _queue_iteration(noise, rng, num_mini_batch, actor_rows, critic_rows, epochs):
    """Queue the draws of one JAX ``train_iteration`` from its ``rng``."""
    rng, k_roll, k_order, k_update, k_critic = jax.random.split(rng, 5)
    for k in jax.random.split(k_roll, T):
        k_act, k_env = jax.random.split(k)
        for i in range(N):
            noise.gumbels.append(gumbel_noise(jax.random.fold_in(k_act, i), (B, N_ACT)))
        noise.resets.append(step_smaclite_reset_noise(k_env, B, N, N))
    perm = np.asarray(jax.random.permutation(k_order, N))
    noise.perms.append(perm)
    if num_mini_batch > 1:
        key = k_update
        for _ in perm:
            key, k_up = jax.random.split(key)
            noise.perms.extend(_perms(k_up, epochs, actor_rows))
        noise.perms.extend(_perms(k_critic, epochs, critic_rows))
    return k_roll


def _jax_rollout_and_returns(jr, js, k_roll):
    """The JAX rollout of ``train_iteration`` and the FP returns of
    ``update_phase`` (on_policy.py:399-469), computed apart."""
    carry, data = jax.lax.scan(
        lambda c, k: jr.rollout_step(js.actors, js.critic.params, c, k),
        js.carry, jax.random.split(k_roll, T))
    nv, _ = jr.critic.get_values(js.critic.params, carry.share_obs.reshape(B * N, -1),
                                 carry.critic_rnn, carry.masks.reshape(B * N, 1))
    values = jvn.denormalize(js.value_norm,
                             jnp.concatenate([data["value"], nv.reshape(B, N, 1)[None]]))
    masks = jnp.concatenate([data["masks"][0][None], data["next_masks"]])
    bad = jnp.concatenate([jnp.ones((1, B, N, 1)), data["next_bad_masks"]])
    ret = jret.compute_gae(data["reward"], values, masks, bad, jr.gamma, jr.gae_lambda)
    return data, ret


def _close(a, b, rtol=DATA_RTOL, atol=DATA_ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _load(net, flax_params, to_state_dict):
    net.load_state_dict(to_state_dict(jax.tree.map(np.asarray, flax_params)))


@pytest.mark.parametrize("chunked,num_mini_batch", [
    (True, 1),    # the SMACLite bench's settings: chunked BPTT, one minibatch
    (False, 2),   # naive recurrent: whole env threads, shuffled minibatches
])
def test_smaclite_fp_recurrent_iteration_matches_jax(chunked, num_mini_batch):
    algo_args, env_args = _configs(chunked, num_mini_batch)
    jr = JRunner(ARGS, copy.deepcopy(algo_args), copy.deepcopy(env_args))
    js = jr.init_state(0)
    assert jr.returns_impl == "scan"   # the JAX reference's CPU form (on_policy.py:94-98)

    noise = ReplayNoise()
    _, k_env, *_ = jax.random.split(jax.random.PRNGKey(0), N + 2)
    noise.resets.append(smaclite_reset_noise(jax.random.split(k_env, B), N, N))
    tr = OnPolicyRunner(ARGS, algo_args, env_args, device="cpu", noise=noise)
    ts = tr.init_state(0)
    _close(ts.carry.env_state.ally_pos, js.carry.env_state.ally_pos, 1e-5, 1e-6)
    _close(ts.carry.share_obs, js.carry.share_obs, 1e-5, 1e-6)
    np.testing.assert_array_equal(ts.carry.avail.numpy(), np.asarray(js.carry.avail))
    for st, jst in zip(ts.actors, js.actors):
        _load(st.net, jst.params, convert.policy_state_dict)
    _load(ts.critic.net, js.critic.params, convert.vnet_state_dict)

    actor_rows = tr.actors[0].chunking.rows(T, B)
    critic_rows = tr.critic.chunking.rows(T, B * N)
    assert (actor_rows, critic_rows) == ((B * T // L, B * N * T // L) if chunked else (B, B * N))
    k_roll = _queue_iteration(noise, js.rng, num_mini_batch, actor_rows, critic_rows, 2)
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

    # rollout data: discrete parts exactly, floats within the tolerance
    data = seen["data"]
    for k in ("masks", "active_masks", "avail", "next_masks", "next_bad_masks", "next_active",
              "emitted_cnt"):
        np.testing.assert_array_equal(data[k].numpy(), np.asarray(jdata[k]), err_msg=k)
    for k in ("obs", "share_obs", "value", "reward", "emitted_ret", "critic_rnn"):
        _close(data[k], jdata[k])
    for i in range(N):
        np.testing.assert_array_equal(data["actions"][i].numpy(), np.asarray(jdata["actions"][i]))
        _close(data["logp"][i], jdata["logp"][i])
        _close(data["actor_rnn"][i], jdata["actor_rnn"][i])
    for k, v in jdata["emitted_metrics"].items():
        _close(data["emitted_metrics"][k], v)
    assert float(data["emitted_cnt"].sum()) >= B          # every env ended an episode
    assert float((1 - data["next_bad_masks"]).sum()) > 0   # some of them by truncation
    assert float((1 - data["avail"]).sum()) > 0            # masks were in play
    _close(seen["returns"], jreturns)

    # per-agent stats, critic stats and the episode bookkeeping
    _close(tm["actor_stats"], jm["actor_stats"])
    for k in ("value_loss", "critic_grad_norm", "mean_step_reward", "dead_ratio",
              "episode_return_sum", "episode_count"):
        _close(tm[k], jm[k])
    assert set(tm["episode_metric_sums"]) == {"won", "dead_allies", "dead_enemies"}
    for k, v in jm["episode_metric_sums"].items():
        _close(tm["episode_metric_sums"][k], v)

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
    _close(ts.carry.share_obs, js2.carry.share_obs)
    _close(ts.carry.critic_rnn, js2.carry.critic_rnn)
    for h, jh in zip(ts.carry.actor_rnn, js2.carry.actor_rnn):
        _close(h, jh)
    np.testing.assert_array_equal(ts.carry.avail.numpy(), np.asarray(js2.carry.avail))


def test_smaclite_yaml_copy_matches():
    assert get_defaults_yaml_args("happo", "smaclite") == jdefaults("happo", "smaclite")
