"""Port parity: replayed runner work on the envs of the dexhands and Humanoid
slice against the JAX runners — a HAPPO ``train_iteration`` on
ShadowHandOver (two 20-joint hands, episodes truncated inside the rollout),
a HAPPO ``train_iteration`` on Humanoid 17x1 (17 one-joint agents, fixed
physical obs scaling as in the tuned config), and a HASAC warmup, collect
and train block on the table task ShadowHandBlockStack.

The Humanoid case is marked ``slow``: the JAX runner's compile of a rollout
through the 23-DOF physics (``jax.jacfwd`` and nested ``jax.jvp`` in each of
5 substeps) takes ~75 s on one CPU core, ~49 s even for the 2-agent 9|8
split, against 0.3 s for the port's iteration; ``tests/test_torch_humanoid.py``
holds the env itself against the JAX env in the tier-1 run.

As in ``tests/test_torch_runner_family.py`` and
``tests/test_torch_runner_off_policy.py``: the JAX runner starts from
``init_state(0)``, the port's gets the JAX parameters through ``convert``
and, through a replaying noise source, every draw the JAX runner derives
from its keys, the envs' reset draws in the form of their
``reset_noise_spec`` (``tests/torch_replay.py``). Tolerances are those
files': data at rtol 1e-4 / atol 2e-4, parameters at rtol 1e-4 / atol 1e-5.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from harl_tpu.runners.off_policy import OffPolicyRunner as JOffRunner
from harl_tpu.runners.on_policy import OnPolicyRunner as JRunner
from harl_tpu.utils.config_tools import get_defaults_yaml_args as jdefaults
from harl_tpu_torch.runners.off_policy import OffPolicyRunner
from harl_tpu_torch.runners.on_policy import OnPolicyRunner
from harl_tpu_torch.utils import convert

from tests.test_torch_runner_off_policy import _load
from tests.torch_replay import ReplayNoise, _step_reset_keys, env_reset_noise, normal, uniform

B, T = 4, 6
DATA_RTOL, DATA_ATOL = 1e-4, 2e-4
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5

ON_CASES = {
    # name: (env, env_args)
    "happo-shadowhandover": ("dexhands_jax", {"task": "ShadowHandOver",
                                              "hands_episode_length": 4}),
    "happo-humanoid-17x1": pytest.param(
        "mamujoco_jax", {"scenario": "Humanoid-v2", "agent_conf": "17x1", "episode_limit": 4,
                         "obs_standardize": False}, marks=pytest.mark.slow),
}


def _close(a, b, rtol=DATA_RTOL, atol=DATA_ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _resets(env, k_env, first=False):
    keys = jax.random.split(k_env, B) if first else _step_reset_keys(k_env, B)
    return env_reset_noise(env, keys)


@pytest.mark.parametrize("env,env_updates", list(ON_CASES.values()), ids=list(ON_CASES))
def test_happo_iteration_matches_jax(env, env_updates):
    algo_args, env_args = jdefaults("happo", env)
    algo_args["train"].update(n_rollout_threads=B, episode_length=T, num_env_steps=T * B)
    algo_args["model"].update(hidden_sizes=[16, 16])
    algo_args["algo"].update(critic_epoch=2, ppo_epoch=2)
    env_args.update(env_updates)
    args = {"algo": "happo", "env": env, "exp_name": "parity"}
    jr = JRunner(args, copy.deepcopy(algo_args), copy.deepcopy(env_args))
    js = jr.init_state(0)
    N = jr.n_agents

    noise = ReplayNoise()
    tr = OnPolicyRunner(args, algo_args, env_args, device="cpu", noise=noise)
    _, k_env, *_ = jax.random.split(jax.random.PRNGKey(0), N + 2)
    noise.resets.append(_resets(tr.env, k_env, first=True))
    ts = tr.init_state(0)
    for st, jst in zip(ts.actors, js.actors):
        st.net.load_state_dict(convert.policy_state_dict(_np(jst.params)))
    ts.critic.net.load_state_dict(convert.vnet_state_dict(_np(js.critic.params)))

    _, k_roll, k_order, _, _ = jax.random.split(js.rng, 5)
    for k in jax.random.split(k_roll, T):
        k_act, k_env = jax.random.split(k)
        for i, sp in enumerate(jr.act_spaces):
            noise.actions.append(normal(jax.random.fold_in(k_act, i), (B, sp.shape[0])))
        noise.resets.append(_resets(tr.env, k_env))
    noise.perms.append(np.asarray(jax.random.permutation(k_order, N)))
    js, jm = jr._train_iteration(js)
    ts, tm = tr.train_iteration(ts)
    assert noise.drained()
    assert float(tm["episode_count"]) == float(jm["episode_count"]) >= B   # episodes ended
    _close(tm["actor_stats"], jm["actor_stats"])
    for k in ("value_loss", "critic_grad_norm", "mean_step_reward", "episode_return_sum",
              "episode_count"):
        _close(tm[k], jm[k])
    for k, v in tm["episode_metric_sums"].items():
        _close(v, jm["episode_metric_sums"][k])
    for st, jst in zip(ts.actors, js.actors):
        ref = convert.policy_state_dict(_np(jst.params))
        for k, v in st.net.state_dict().items():
            _close(v, ref[k], PARAM_RTOL, PARAM_ATOL)
    ref = convert.vnet_state_dict(_np(js.critic.params))
    for k, v in ts.critic.net.state_dict().items():
        _close(v, ref[k], PARAM_RTOL, PARAM_ATOL)
    _close(ts.carry.share_obs, js.carry.share_obs)


def test_hasac_block_on_a_table_task_matches_jax():
    """Warmup, collect and train on ShadowHandBlockStack (two blocks on the
    table, episodes of 3 steps), replayed: the buffer's rows, the episode
    stats with ``won`` and every network after two updates."""
    algo = "hasac"
    algo_args, env_args = jdefaults(algo, "dexhands_jax")
    algo_args["train"].update(n_rollout_threads=B, warmup_steps=2 * B, train_interval=2,
                              update_per_train=1, num_env_steps=10 ** 6)
    algo_args["algo"].update(batch_size=16, buffer_size=200, n_step=3, auto_alpha=True)
    algo_args["model"].update(hidden_sizes=[16, 16])
    env_args.update(task="ShadowHandBlockStack", hands_episode_length=3)
    args = {"algo": algo, "env": "dexhands_jax", "exp_name": "parity"}
    jr = JOffRunner(args, copy.deepcopy(algo_args), copy.deepcopy(env_args))
    js = jr.init_state(0)
    N, act_dims = jr.n_agents, [sp.shape[0] for sp in jr.act_spaces]

    noise = ReplayNoise()
    tr = OffPolicyRunner(args, algo_args, env_args, device="cpu", noise=noise)
    _, k_env, *_ = jax.random.split(jax.random.PRNGKey(0), N + 3)
    noise.resets.append(_resets(tr.env, k_env, first=True))
    ts = tr.init_state(0)
    _load(ts, js, algo)

    rng = js.rng
    for draw in (uniform, normal):        # the warmup's uniform actions, the collect's normals
        rng, k = jax.random.split(rng)
        for kk in jax.random.split(k, 2):
            k1, k2 = jax.random.split(kk)
            for i, d in enumerate(act_dims):
                (noise.uniforms if draw is uniform else noise.actions).append(
                    draw(jax.random.fold_in(k1, i), (B, d)))
            noise.resets.append(_resets(tr.env, k2))
    cur_size = 4 * B
    for _ in range(2):
        rng, k_sample, k_next, k_actor, k_order = jax.random.split(rng, 5)
        noise.starts.append((cur_size, np.asarray(
            jax.random.randint(k_sample, (16,), 0, jnp.int32(cur_size)))))
        for i, d in enumerate(act_dims):
            noise.actions.append(normal(jax.random.fold_in(k_next, i), (16, d)))
        for i, d in enumerate(act_dims):
            noise.actions.append(normal(jax.random.fold_in(k_actor, 100 + i), (16, d)))
        order = np.asarray(jax.random.permutation(k_order, N))
        noise.perms.append(order)
        for i in order:
            noise.actions.append(normal(jax.random.fold_in(k_actor, int(i)), (16, act_dims[i])))

    js = jr.warmup_block(js)
    js, jcm = jr.collect_block(js)
    js, jtm = jr.train_block(js)
    ts = tr.warmup_block(ts)
    ts, tcm = tr.collect_block(ts)
    rows = ts.buffer.cur_size
    assert rows == int(js.buffer.cur_size) == 4 * B
    for name in ("share_obs", "next_share_obs", "rewards", "dones", "terms"):
        _close(getattr(ts.buffer, name)[:rows], getattr(js.buffer, name)[:rows])
    for name in ("obs", "next_obs", "actions", "valid_transitions"):
        for t, j in zip(getattr(ts.buffer, name), getattr(js.buffer, name)):
            _close(t[:rows], j[:rows])
    assert float(ts.buffer.dones.sum()) >= B          # episodes of 3 steps ended
    for k in ("episode_return_sum", "episode_count", "mean_step_reward"):
        _close(tcm[k], jcm[k])
    ts, ttm = tr.train_block(ts)
    assert noise.drained()
    _close(ttm["critic_loss"], jtm["critic_loss"])
    for st, jst in zip(ts.actors, js.actors):
        ref = convert.squashed_policy_state_dict(_np(jst.params))
        for k, v in st.net.state_dict().items():
            _close(v, ref[k], PARAM_RTOL, PARAM_ATOL)
        _close(st.log_alpha.detach(), jst.log_alpha, PARAM_RTOL, PARAM_ATOL)
    ref = convert.q_nets_state_dict(_np(js.critic.params))
    for k, v in ts.critic.nets.state_dict().items():
        _close(v, ref[k], PARAM_RTOL, PARAM_ATOL)
