"""Port parity: the off-policy runner's blocks, replayed against the JAX runner.

Both runners start from ``init_state(0)``; the port's gets the JAX networks
through ``convert`` and, through a replaying noise source, every draw the
JAX blocks derive from their keys (``off_policy.py``): the warmup's uniform
actions (``fold_in(k1, i)``, ``:291``), the exploration normals of a collect
step (``:268``), the env's reset draws of every step (``core.py:51``), and per
update the replay starts (``k_sample``, ``buffers/off_policy.py:153``), the
next-action or target smoothing normals (``fold_in(k_next, i)``), HASAC's
initial-action normals (``fold_in(k_actor, 100 + i)``), the agent
permutation (``k_order``) and HASAC's agent normals (``fold_in(k_actor, i)``).

HalfCheetah-2x3 (two agents of three joints) keeps the JAX compile of the
sequential ``lax.switch`` small and sums log-probs over three action dims;
one HASAC case runs the bench's 6x1 split.
"""
import copy

import jax
import numpy as np
import pytest

from harl_tpu.runners.off_policy import OffPolicyRunner as JRunner
from harl_tpu.utils.config_tools import get_defaults_yaml_args as jdefaults
from harl_tpu_torch.runners.off_policy import OffPolicyRunner
from harl_tpu_torch.utils import convert

from tests.torch_replay import (ReplayNoise, queue_collect, queue_train, queue_warmup,
                                reset_noise)

B, DOF, BATCH = 4, 9, 16
# The env runs float32 physics free for 4 steps of 5 substeps, as in
# tests/test_torch_runner.py; the buffer's rows and the losses inherit that.
DATA_RTOL, DATA_ATOL = 1e-4, 2e-4
# Parameters after two updates of Adam with eps 1e-8: a step is about
# lr·sign(g) where |g| >> 1e-8, so a gradient's relative error e moves a
# parameter by ~lr·e, and the twin critics, actors and targets stay close.
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5

CASES = [("hasac", "2x3", {}), ("hasac", "2x3", {"auto_alpha": True}),
         ("hasac", "6x1", {}), ("hasac", "6x1", {"auto_alpha": True}), ("hatd3", "2x3", {}),
         ("haddpg", "2x3", {}), ("matd3", "2x3", {}), ("maddpg", "2x3", {})]


def _configs(algo, conf, algo_updates):
    algo_args, env_args = jdefaults(algo, "mamujoco_jax")
    algo_args["train"].update(n_rollout_threads=B, warmup_steps=2 * B, train_interval=2,
                              update_per_train=1, num_env_steps=10 ** 6)
    algo_args["algo"].update(batch_size=BATCH, buffer_size=200, **algo_updates)
    if algo == "hasac":
        algo_args["algo"]["n_step"] = 3
    algo_args["model"].update(hidden_sizes=[16, 16])
    # episodes of 3 steps: warmup and collect cross a truncation in every env
    env_args.update(scenario="HalfCheetah-v2", agent_conf=conf, episode_limit=3)
    return algo_args, env_args


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(a, b, rtol=DATA_RTOL, atol=DATA_ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _policy_sd(algo):
    return (convert.squashed_policy_state_dict if algo == "hasac"
            else convert.deterministic_policy_state_dict)


def _load(ts, js, algo):
    to_sd = _policy_sd(algo)
    for st, jst in zip(ts.actors, js.actors):
        st.net.load_state_dict(to_sd(_np(jst.params)))
        st.target.load_state_dict(to_sd(_np(jst.target_params)))
    ts.critic.nets.load_state_dict(convert.q_nets_state_dict(_np(js.critic.params)))
    ts.critic.targets.load_state_dict(convert.q_nets_state_dict(_np(js.critic.target_params)))


@pytest.mark.parametrize("algo,conf,updates", CASES,
                         ids=[f"{a}-{c}{'-auto_alpha' if u else ''}" for a, c, u in CASES])
def test_blocks_match_jax(algo, conf, updates):
    algo_args, env_args = _configs(algo, conf, updates)
    args = {"algo": algo, "env": "mamujoco_jax", "exp_name": "parity"}
    jr = JRunner(args, copy.deepcopy(algo_args), copy.deepcopy(env_args))
    js = jr.init_state(0)
    N = jr.n_agents
    act_dims = [sp.shape[0] for sp in jr.act_spaces]

    noise = ReplayNoise()
    _, k_env, *_ = jax.random.split(jax.random.PRNGKey(0), N + 3)
    noise.resets.append(reset_noise(jax.random.split(k_env, B), DOF))
    tr = OffPolicyRunner(args, algo_args, env_args, device="cpu", noise=noise)
    ts = tr.init_state(0)
    _load(ts, js, algo)

    rng = queue_warmup(noise, js.rng, 2, act_dims, B, DOF)
    rng = queue_collect(noise, rng, 2, act_dims, B, DOF)
    queue_train(noise, jr, rng, 2, cur_size=4 * B, batch=BATCH)

    js = jr.warmup_block(js)
    js, jcm = jr.collect_block(js)
    js, jtm = jr.train_block(js)
    ts = tr.warmup_block(ts)
    ts, tcm = tr.collect_block(ts)
    rows = ts.buffer.cur_size
    assert rows == int(js.buffer.cur_size) == 4 * B
    jb = js.buffer
    for name in ("share_obs", "next_share_obs", "rewards", "dones", "terms"):
        _close(getattr(ts.buffer, name)[:rows], getattr(jb, name)[:rows])
    for name in ("obs", "next_obs", "actions", "valid_transitions"):
        for t, j in zip(getattr(ts.buffer, name), getattr(jb, name)):
            _close(t[:rows], j[:rows])
    # every env truncated once (episode_limit 3): dones without terms
    assert float(ts.buffer.dones.sum()) == B and float(ts.buffer.terms.sum()) == 0
    for k in ("episode_return_sum", "episode_count", "mean_step_reward"):
        _close(tcm[k], jcm[k])
    _close(ts.carry.obs, js.carry.obs)
    _close(ts.carry.ep_ret, js.carry.ep_ret)

    ts, ttm = tr.train_block(ts)
    assert noise.drained()
    assert ts.total_it == int(js.total_it) == 2
    _close(ttm["critic_loss"], jtm["critic_loss"])
    to_sd = _policy_sd(algo)
    for st, jst in zip(ts.actors, js.actors):
        for net, params in ((st.net, jst.params), (st.target, jst.target_params)):
            ref = to_sd(_np(params))
            for k, v in net.state_dict().items():
                _close(v, ref[k], PARAM_RTOL, PARAM_ATOL)
        if updates.get("auto_alpha"):
            _close(st.log_alpha.detach(), jst.log_alpha, PARAM_RTOL, PARAM_ATOL)
    for nets, params in ((ts.critic.nets, js.critic.params),
                         (ts.critic.targets, js.critic.target_params)):
        ref = convert.q_nets_state_dict(_np(params))
        for k, v in nets.state_dict().items():
            _close(v, ref[k], PARAM_RTOL, PARAM_ATOL)
    if updates.get("auto_alpha"):
        _close(ts.critic.log_alpha.detach(), js.critic.log_alpha, PARAM_RTOL, PARAM_ATOL)
    if ts.critic.value_norm is not None:
        for name in ("running_mean", "running_mean_sq", "debiasing_term"):
            _close(getattr(ts.critic.value_norm, name), getattr(js.critic.value_norm, name))
