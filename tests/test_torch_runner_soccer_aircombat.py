"""Port parity: replayed runner work on the envs of the ninth slice against
the JAX runners — a HAPPO ``train_iteration`` on academy soccer (Discrete(19)
with availability rows; ``simple`` vectors, and ``pixels`` through
``CNNBase``), a HAPPO ``train_iteration`` on 2v2 air combat (MultiDiscrete
heads, one Gumbel draw a sub-head from the agent's key split three ways;
active masks from downed allies), and HASAC warmup, collect and train
blocks on 2v2 air combat (MultiDiscrete: per-sub-head straight-through
Gumbel-softmax from ``fold_in``, one ``randint`` a sub-action in the warmup,
one-hot joint actions) and on a small manyagent swimmer.

The JAX off-policy runner cannot build on a MultiDiscrete space:
``OffPolicyRunner.init_state`` reads ``sp.n`` for every non-Box space
(``harl_tpu/runners/off_policy.py:224``), which a MultiDiscrete space has
not (ROADMAP.md, Queue C). The test builds it with ``discrete`` set to
False after construction, which keeps every other path as it is (no
availability rows, float actions in the buffer, the one-hots cast back).

As in ``tests/test_torch_runner_hands_humanoid.py``: the JAX runner starts
from ``init_state(0)``, the port's gets the JAX parameters through
``convert`` and every draw through a replaying noise source
(``tests/torch_replay.py``). Data at rtol 1e-4 / atol 2e-4, parameters at
rtol 1e-4 / atol 1e-5, as there.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harl_tpu.runners.off_policy import OffPolicyRunner as JOffRunner
from harl_tpu.runners.on_policy import OnPolicyRunner as JRunner
from harl_tpu.utils.config_tools import get_defaults_yaml_args as jdefaults
from harl_tpu_torch.runners.off_policy import OffPolicyRunner
from harl_tpu_torch.runners.on_policy import OnPolicyRunner
from harl_tpu_torch.utils import convert

from tests.torch_replay import (ReplayNoise, _step_reset_keys, aircombat_reset_noise,
                                gumbel_noise, multi_gumbel_fold_in, multi_gumbel_split, normal,
                                randint, soccer_reset_noise, swimmer_reset_noise, uniform)

B, T = 4, 6
DATA_RTOL, DATA_ATOL = 1e-4, 2e-4
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5


def _close(a, b, rtol=DATA_RTOL, atol=DATA_ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _resets(env_name, env, keys):
    if env_name == "football_jax":
        return soccer_reset_noise(keys, env.n_agents, env.n_defenders)
    if env_name == "lag_jax":
        return aircombat_reset_noise(keys, env.n_allies, env.n_enemies)
    return swimmer_reset_noise(keys, env.n_links)


ON_CASES = {
    "soccer-3v1": ("football_jax", {"env_name": "academy_3_vs_1_with_keeper",
                                    "episode_limit": 4}),
    "soccer-pixels": ("football_jax", {"env_name": "academy_pass_and_shoot_with_keeper",
                                       "representation": "pixels", "episode_limit": 4}),
    "aircombat-2v2": ("lag_jax", {"scenario": "2v2", "episode_limit": 5}),
}


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
    if env == "lag_jax":
        # allies start in a dogfight, one of them low and diving, so that
        # downed allies clear active masks within the rollout
        rng = np.random.default_rng(3)
        pos = np.array(js.carry.env_state.pos)
        pos[:, :, :2] = rng.uniform(-400.0, 400.0, pos[:, :, :2].shape)
        pos[:, 0, 2] = 110.0
        gamma = np.array(js.carry.env_state.gamma)
        gamma[:, 0] = -0.5
        js = js._replace(carry=js.carry._replace(env_state=js.carry.env_state._replace(
            pos=jnp.asarray(pos), gamma=jnp.asarray(gamma))))

    noise = ReplayNoise()
    tr = OnPolicyRunner(args, algo_args, env_args, device="cpu", noise=noise)
    _, k_env, *_ = jax.random.split(jax.random.PRNGKey(0), N + 2)
    noise.resets.append(_resets(env, tr.env, jax.random.split(k_env, B)))
    ts = tr.init_state(0)
    if env == "lag_jax":
        ts.carry = ts.carry._replace(env_state=type(ts.carry.env_state)(
            *(torch.from_numpy(np.array(x)) for x in js.carry.env_state)))
    for st, jst in zip(ts.actors, js.actors):
        st.net.load_state_dict(convert.policy_state_dict(_np(jst.params)))
    ts.critic.net.load_state_dict(convert.vnet_state_dict(_np(js.critic.params)))

    _, k_roll, k_order, _, _ = jax.random.split(js.rng, 5)
    for k in jax.random.split(k_roll, T):
        k_act, k_env = jax.random.split(k)
        for i, sp in enumerate(jr.act_spaces):
            ki = jax.random.fold_in(k_act, i)
            if env == "lag_jax":
                noise.gumbels.extend(multi_gumbel_split(ki, [(B, n) for n in sp.nvec]))
            else:
                noise.gumbels.append(gumbel_noise(ki, (B, sp.n)))
        noise.resets.append(_resets(env, tr.env, _step_reset_keys(k_env, B)))
    noise.perms.append(np.asarray(jax.random.permutation(k_order, N)))
    js, jm = jr._train_iteration(js)
    ts, tm = tr.train_iteration(ts)
    assert noise.drained()
    assert float(tm["episode_count"]) == float(jm["episode_count"]) >= B   # episodes ended
    _close(tm["actor_stats"], jm["actor_stats"])
    for k in ("value_loss", "critic_grad_norm", "mean_step_reward", "episode_return_sum",
              "episode_count", "dead_ratio"):
        _close(tm[k], jm[k])
    if env == "lag_jax":
        assert float(tm["dead_ratio"]) > 0.0          # downed allies were masked
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


OFF_CASES = {
    "aircombat-2v2": ("lag_jax", {"scenario": "2v2", "episode_limit": 3}),
    "swimmer-2x1": ("mamujoco_jax", {"scenario": "manyagent_swimmer", "agent_conf": "2x1",
                                     "episode_limit": 3}),
}


@pytest.mark.parametrize("env,env_updates", list(OFF_CASES.values()), ids=list(OFF_CASES))
def test_hasac_blocks_match_jax(env, env_updates):
    """Warmup, collect and train (2 updates), episodes of 3 steps: the
    buffer's rows, the episode stats and every network after training."""
    algo_args, env_args = jdefaults("hasac", env)
    algo_args["train"].update(n_rollout_threads=B, warmup_steps=2 * B, train_interval=2,
                              update_per_train=1, num_env_steps=10 ** 6)
    algo_args["algo"].update(batch_size=16, buffer_size=200, n_step=3, auto_alpha=True)
    algo_args["model"].update(hidden_sizes=[16, 16])
    env_args.update(env_updates)
    args = {"algo": "hasac", "env": env, "exp_name": "parity"}
    jr = JOffRunner(args, copy.deepcopy(algo_args), copy.deepcopy(env_args))
    md = env == "lag_jax"
    if md:
        jr.discrete = False    # its init_state reads sp.n of every non-Box space
    js = jr.init_state(0)
    N = jr.n_agents

    noise = ReplayNoise()
    tr = OffPolicyRunner(args, algo_args, env_args, device="cpu", noise=noise)
    _, k_env, *_ = jax.random.split(jax.random.PRNGKey(0), N + 3)
    noise.resets.append(_resets(env, tr.env, jax.random.split(k_env, B)))
    ts = tr.init_state(0)
    to_sd = convert.policy_state_dict if md else convert.squashed_policy_state_dict
    for st, jst in zip(ts.actors, js.actors):
        st.net.load_state_dict(to_sd(_np(jst.params)))
        st.target.load_state_dict(to_sd(_np(jst.target_params)))
    ts.critic.nets.load_state_dict(convert.q_nets_state_dict(_np(js.critic.params)))
    ts.critic.targets.load_state_dict(convert.q_nets_state_dict(_np(js.critic.target_params)))

    def draws(key, batch, warm=False):
        """Agent i's draws from ``fold_in(key, i)``."""
        for i, sp in enumerate(jr.act_spaces):
            ki = jax.random.fold_in(key, i)
            if md and warm:
                for j, n in enumerate(sp.nvec):
                    noise.ints.append((n, randint(jax.random.fold_in(ki, j), (batch,), n)))
            elif md:
                noise.gumbels.extend(multi_gumbel_fold_in(ki, [(batch, n) for n in sp.nvec]))
            else:
                (noise.uniforms if warm else noise.actions).append(
                    (uniform if warm else normal)(ki, (batch, sp.shape[0])))

    rng = js.rng
    for warm in (True, False):            # the warmup's random actions, the collect's draws
        rng, k = jax.random.split(rng)
        for kk in jax.random.split(k, 2):
            k1, k2 = jax.random.split(kk)
            draws(k1, B, warm)
            noise.resets.append(_resets(env, tr.env, _step_reset_keys(k2, B)))
    cur_size = 4 * B
    for _ in range(2):
        rng, k_sample, k_next, k_actor, k_order = jax.random.split(rng, 5)
        noise.starts.append((cur_size, np.asarray(
            jax.random.randint(k_sample, (16,), 0, jnp.int32(cur_size)))))
        for i, sp in enumerate(jr.act_spaces):
            ki = jax.random.fold_in(k_next, i)
            if md:
                noise.gumbels.extend(multi_gumbel_fold_in(ki, [(16, n) for n in sp.nvec]))
            else:
                noise.actions.append(normal(ki, (16, sp.shape[0])))
        order = np.asarray(jax.random.permutation(k_order, N))
        for pass_keys in ([100 + i for i in range(N)], None):
            if pass_keys is None:
                noise.perms.append(order)
                pass_keys = [int(i) for i in order]
            for key_i in pass_keys:
                i = key_i - 100 if key_i >= 100 else key_i
                sp, ki = jr.act_spaces[i], jax.random.fold_in(k_actor, key_i)
                if md:
                    noise.gumbels.extend(multi_gumbel_fold_in(ki, [(16, n) for n in sp.nvec]))
                else:
                    noise.actions.append(normal(ki, (16, sp.shape[0])))

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
    assert tr.target_entropy == pytest.approx(jr.target_entropy)
    for st, jst in zip(ts.actors, js.actors):
        ref = to_sd(_np(jst.params))
        for k, v in st.net.state_dict().items():
            _close(v, ref[k], PARAM_RTOL, PARAM_ATOL)
        _close(st.log_alpha.detach(), jst.log_alpha, PARAM_RTOL, PARAM_ATOL)
    ref = convert.q_nets_state_dict(_np(js.critic.params))
    for k, v in ts.critic.nets.state_dict().items():
        _close(v, ref[k], PARAM_RTOL, PARAM_ATOL)
