"""Port parity: one on-policy iteration on host envs, replayed against the
JAX runner's ``host_train_iteration`` (on_policy.py:725-736).

Both runners step their own host envs, built from the same arguments and
seeded alike (the native MuJoCo engine's ``ensure_envs(B)``, seed 1; gym's
``HostVecEnv`` seeds 1 + 1000·i). The port's runner gets the JAX
parameters through ``convert`` and, through a replaying noise source, the
draws the JAX host path derives from its keys: one split of the state's
rng a step with agent i sampling from ``fold_in(k, i)`` (``:658``,
``:289``), then the agent permutation from ``split(rng, 4)`` (``:727``).
``host_eval`` (``:738-793``) samples the training policy the same way from
``fold_in(rng, 99)``.

HalfCheetah-3x2 on the native engine takes Box actions, which differ from
JAX's in the last bits (the networks' sums), so its envs' states, actions
and returns are held at the data tolerance; CartPole with a GRU takes
Discrete actions, exactly equal, so its observations and rewards are too.
"""
import copy

import jax
import numpy as np
import pytest

from harl_tpu.runners.on_policy import OnPolicyRunner as JRunner
from harl_tpu.utils.config_tools import get_defaults_yaml_args as jdefaults
from harl_tpu_torch.envs.gym.gym_env import GymEnv
from harl_tpu_torch.envs.host import HostVecEnv
from harl_tpu_torch.envs.mamujoco.native_vec import NativeMAMuJoCoVec
from harl_tpu_torch.runners.on_policy import OnPolicyRunner
from harl_tpu_torch.utils import convert

from tests.torch_replay import ReplayNoise, queue_host_rollout, queue_host_update

# the tolerances of the planar iteration (test_torch_runner.py)
DATA_RTOL, DATA_ATOL = 1e-4, 2e-4
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
B = 4
CASES = {
    # HalfCheetah 3x2 on the native engine, 12 steps; 8-step episodes truncate
    "mamujoco": (12, {"scenario": "HalfCheetah-v2", "agent_conf": "3x2", "episode_limit": 8,
                      "backend": "native"}, {}),
    # CartPole with GRU actors and critic, 36 steps in chunks of 6; poles fall
    "gym": (36, {"scenario": "CartPole-v1"},
            {"use_recurrent_policy": True, "recurrent_n": 1, "data_chunk_length": 6}),
}


def _configs(env):
    T, env_args, model = CASES[env]
    algo_args, defaults = jdefaults("happo", env)
    algo_args["train"].update(n_rollout_threads=B, episode_length=T, num_env_steps=10 ** 6)
    algo_args["model"].update(hidden_sizes=[16, 16], **model)
    algo_args["algo"].update(ppo_epoch=2, critic_epoch=2)
    return algo_args, {**defaults, **env_args}


def _close(a, b, rtol=DATA_RTOL, atol=DATA_ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _draws(jr, batch):
    return [("gumbel" if jr.discrete else "normal",
             (batch, sp.n if jr.discrete else sp.shape[0])) for sp in jr.act_spaces]


def _runners(env):
    algo_args, env_args = _configs(env)
    args = {"algo": "happo", "env": env, "exp_name": "parity"}
    jr = JRunner(args, copy.deepcopy(algo_args), copy.deepcopy(env_args))
    js = jr.init_state(0)
    noise = ReplayNoise()
    tr = OnPolicyRunner(args, algo_args, env_args, device="cpu", noise=noise)
    ts = tr.init_state(0)
    for st, jst in zip(ts.actors, js.actors):
        st.net.load_state_dict(convert.policy_state_dict(jax.tree.map(np.asarray, jst.params)))
    ts.critic.net.load_state_dict(convert.vnet_state_dict(
        jax.tree.map(np.asarray, js.critic.params)))
    return jr, js, tr, ts, noise


@pytest.mark.parametrize("env", sorted(CASES))
def test_host_train_iteration_matches_jax(env):
    jr, js, tr, ts, noise = _runners(env)
    assert jr.host_mode and tr.host_mode
    assert isinstance(tr.vec, NativeMAMuJoCoVec if env == "mamujoco" else HostVecEnv)
    if env == "gym":
        assert isinstance(tr.vec.envs[0], GymEnv) and tr.use_rnn
    # both resets start from the same seeds, with no draw
    np.testing.assert_array_equal(ts.carry.obs.numpy(), np.asarray(js.carry.obs))
    np.testing.assert_array_equal(ts.carry.share_obs.numpy(), np.asarray(js.carry.share_obs))

    rng = queue_host_rollout(noise, js.rng, jr.episode_length, _draws(jr, B))
    queue_host_update(noise, rng, jr.n_agents)
    seen = {}
    collect = jr.collect_host

    def spy(state):
        out = collect(state)
        seen["jdata"] = out[1]
        return out

    jr.collect_host = spy
    js2, jm = jr.host_train_iteration(js)
    update_phase = tr.update_phase

    def tspy(state, data, *last):
        seen["data"] = data
        return update_phase(state, data, *last)

    tr.update_phase = tspy
    ts, tm = tr.train_iteration(ts)
    assert noise.drained()

    data, jdata = seen["data"], seen["jdata"]
    for k in ("masks", "active_masks", "next_masks", "next_bad_masks", "next_active",
              "emitted_cnt"):
        np.testing.assert_array_equal(data[k].numpy(), np.asarray(jdata[k]), err_msg=k)
    exact = env == "gym"   # Discrete actions: the same envs see the same actions
    for k in ("obs", "share_obs", "reward", "emitted_ret"):
        if exact:
            np.testing.assert_array_equal(data[k].numpy(), np.asarray(jdata[k]), err_msg=k)
        else:
            _close(data[k], jdata[k])
    _close(data["value"], jdata["value"])
    for i in range(jr.n_agents):
        if exact:
            np.testing.assert_array_equal(data["actions"][i].numpy(),
                                          np.asarray(jdata["actions"][i]))
            np.testing.assert_array_equal(data["avail"].numpy(), np.asarray(jdata["avail"]))
            _close(data["actor_rnn"][i], jdata["actor_rnn"][i])
        else:
            _close(data["actions"][i], jdata["actions"][i])
        _close(data["logp"][i], jdata["logp"][i])
    if exact:
        _close(data["critic_rnn"], jdata["critic_rnn"])
    # every env ended an episode: by truncation (HalfCheetah) or a fall
    # (CartPole, a termination)
    assert float(data["emitted_cnt"].sum()) >= B
    truncations = float((1 - data["next_bad_masks"]).sum())
    assert truncations == (B if env == "mamujoco" else 0)

    _close(tm["actor_stats"], jm["actor_stats"])
    for k in ("value_loss", "critic_grad_norm", "mean_step_reward", "dead_ratio",
              "episode_return_sum", "episode_count"):
        _close(tm[k], jm[k])
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
    _close(ts.carry.ep_ret, js2.carry.ep_ret)

    # host_eval: the training policy sampled from fold_in(rng, 99) on fresh
    # envs seeded from 50000; the draws of every step up to the horizon are
    # queued, the port takes those of the steps it runs
    n_eval = 3
    eval_noise = ReplayNoise()
    queue_host_rollout(eval_noise, jax.random.fold_in(js2.rng, 99),
                       jr.env.episode_limit if env == "mamujoco" else 500,
                       _draws(jr, n_eval))
    ret = tr.host_eval(ts, n_eval, noise=eval_noise)
    jret = jr.host_eval(js2, n_eval)
    if exact:
        assert ret == jret
    else:
        _close(ret, jret)
