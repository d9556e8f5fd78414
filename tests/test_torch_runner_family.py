"""Port parity: full replayed ``train_iteration``s of the rest of the
on-policy family against the JAX runner — HATRPO (HalfCheetah 2x3, and
SMACLite 3m with the FP state and GRUs), HAA2C with linear lr decay, MAPPO
with ``share_param`` (one update on the merged batch), HAPPO with
``share_param`` (old log-probs re-evaluated before each agent) and HAPPO on
MPE speaker-listener with discrete actions (heterogeneous agents: obs 3 and
11 wide padded to 11, Discrete(3) and Discrete(5) heads masked by the
availability of the padded rows), HAPPO on the 3D Ant 2x4, and HAPPO with
GRUs on SMACv2 protoss_5_vs_5 (teams and spawns drawn at every reset).

As in ``tests/test_torch_runner.py``: the JAX runner starts from
``init_state(0)``, the port's runner gets the JAX parameters through
``convert`` and, through a replaying noise source, the draws the JAX
iteration derives from its keys: the action normals (``fold_in(k_act, i)``)
or Gumbels, every env step's reset draws, the agent permutation
(``k_order``) unless the order is fixed or MAPPO merges the agents, and with
several minibatches the per-epoch shuffles (per agent from ``k_up``, for the
merged MAPPO batch from ``k_update`` itself, over T·B·N rows; the critic's
from ``k_critic``).
"""
import copy

import jax
import numpy as np
import pytest

from harl_tpu.runners.on_policy import OnPolicyRunner as JRunner
from harl_tpu.utils.config_tools import get_defaults_yaml_args as jdefaults
from harl_tpu_torch.runners.on_policy import OnPolicyRunner
from harl_tpu_torch.utils import convert, spaces

from tests.torch_replay import (ReplayNoise, gumbel_noise, mpe_reset_noise, reset_noise,
                                smaclite_reset_noise, smacv2_reset_noise, step_mpe_reset_noise,
                                step_reset_noise, step_smaclite_reset_noise,
                                step_smacv2_reset_noise)

B, T, DOF = 6, 10, 9
# the tolerances of the HAPPO iterations (tests/test_torch_runner.py)
DATA_RTOL, DATA_ATOL = 1e-4, 2e-4
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
# HATRPO's parameters move by a CG solution scaled to the KL radius: float32
# rounding in the FVPs reaches them amplified (tests/test_torch_hatrpo.py)
TRPO_PARAM_RTOL, TRPO_PARAM_ATOL = 1e-3, 1e-5

CASES = {
    # name: (algo, env, algo section updates, iterations)
    "hatrpo-halfcheetah": ("hatrpo", "mamujoco_jax", {"backtrack_coeff": 0.5}, 1),
    "haa2c-lr-decay": ("haa2c", "mamujoco_jax", {"a2c_epoch": 2, "actor_num_mini_batch": 2,
                                                  "critic_num_mini_batch": 2}, 2),
    "mappo-share-param": ("mappo", "mamujoco_jax", {"share_param": True, "fixed_order": True,
                                                     "ppo_epoch": 2,
                                                     "actor_num_mini_batch": 2}, 1),
    "happo-share-param": ("happo", "mamujoco_jax", {"share_param": True, "ppo_epoch": 2}, 1),
    "hatrpo-smaclite-fp-gru": ("hatrpo", "smaclite", {"backtrack_coeff": 0.5}, 1),
    "happo-speaker-listener-discrete": ("happo", "pettingzoo_mpe", {}, 1),
    "happo-ant-2x4": ("happo", "mamujoco_jax", {}, 1,
                      {"scenario": "Ant-v2", "agent_conf": "2x4"}),
    "happo-smacv2-protoss-gru": ("happo", "smacv2", {}, 1, {"map_name": "protoss_5_vs_5"}),
}


def _configs(algo, env, algo_updates, iterations, env_updates=None):
    algo_args, env_args = jdefaults(algo, env)
    algo_args["train"].update(n_rollout_threads=B, episode_length=T,
                              num_env_steps=iterations * T * B,
                              use_linear_lr_decay=algo == "haa2c")
    algo_args["model"].update(hidden_sizes=[16, 16])
    algo_args["algo"].update(critic_epoch=2, **algo_updates)
    if env in ("smaclite", "smacv2"):
        algo_args["model"].update(use_recurrent_policy=True, recurrent_n=1, data_chunk_length=5)
        env_args.update(map_name="3m", state_type="FP", episode_limit=7)
        if env == "smacv2":   # the tuned SMACv2 configs' EP state
            env_args.update(state_type="EP")
    elif env == "pettingzoo_mpe":
        env_args.update(scenario="simple_speaker_listener_v3", continuous_actions=False,
                        max_cycles=7)
    else:
        # episodes of 7 steps: the 10-step rollout truncates and auto-resets
        env_args.update(scenario="HalfCheetah-v2", agent_conf="2x3", episode_limit=7)
    env_args.update(env_updates or {})
    return algo_args, env_args


def _perms(key, epochs, rows):
    return list(np.asarray(jax.vmap(lambda k: jax.random.permutation(k, rows))(
        jax.random.split(key, epochs))))


def _queue_iteration(noise, jr, tr, rng):
    """Queue the draws of one JAX ``train_iteration`` from its ``rng``;
    returns the next iteration's rng."""
    N = jr.n_agents
    rng, k_roll, k_order, k_update, k_critic = jax.random.split(rng, 5)
    smac = jr.state_type == "FP"
    for k in jax.random.split(k_roll, T):
        k_act, k_env = jax.random.split(k)
        for i, sp in enumerate(jr.act_spaces):
            key = jax.random.fold_in(k_act, i)
            if spaces.space_kind(sp) == "Discrete":
                noise.gumbels.append(gumbel_noise(key, (B, sp.n)))
            else:
                noise.actions.append(np.asarray(jax.random.normal(key, (B, sp.shape[0]))))
        noise.resets.append(_step_reset(jr, k_env, N))
    actor = tr.actors[0]
    if jr.share_param and not jr.factor_chain:
        if actor.num_mini_batch > 1:
            noise.perms.extend(_perms(k_update, actor.ppo_epoch,
                                      actor.chunking.rows(T, B * N)))
    else:
        order = range(N)
        if not jr.fixed_order:
            order = np.asarray(jax.random.permutation(k_order, N))
            noise.perms.append(order)
        if actor.num_mini_batch > 1:
            key = k_update
            for _ in order:
                key, k_up = jax.random.split(key)
                noise.perms.extend(_perms(k_up, actor.ppo_epoch, actor.chunking.rows(T, B)))
    if tr.critic.num_mini_batch > 1:
        noise.perms.extend(_perms(k_critic, tr.critic.critic_epoch,
                                  tr.critic.chunking.rows(T, B * N if smac else B)))
    return rng


def _step_reset(jr, k_env, N):
    env = jr.args["env"]
    if env == "smaclite":
        return step_smaclite_reset_noise(k_env, B, N, N)
    if env == "smacv2":
        return step_smacv2_reset_noise(k_env, B, N, jr.env.n_enemies)
    if env == "pettingzoo_mpe":
        return step_mpe_reset_noise(k_env, B, N, goals=True)
    return step_reset_noise(k_env, B, _dof(jr))


def _reset(jr, k_env, N):
    env = jr.args["env"]
    keys = jax.random.split(k_env, B)
    if env == "smaclite":
        return smaclite_reset_noise(keys, N, N)
    if env == "smacv2":
        return smacv2_reset_noise(keys, N, jr.env.n_enemies)
    if env == "pettingzoo_mpe":
        return mpe_reset_noise(keys, N, goals=True)
    return reset_noise(keys, _dof(jr))


def _dof(jr):
    """The reset draws' width: the planar cheetah's 9 DOF or the Ant's 14."""
    return 14 if jr.env_args.get("scenario", "").startswith("Ant") else DOF


def _close(a, b, rtol=DATA_RTOL, atol=DATA_ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("case", list(CASES))
def test_iterations_match_jax(case):
    algo, env, updates, iterations, *env_updates = CASES[case]
    algo_args, env_args = _configs(algo, env, updates, iterations, *env_updates)
    args = {"algo": algo, "env": env, "exp_name": "parity"}
    jr = JRunner(args, copy.deepcopy(algo_args), copy.deepcopy(env_args))
    js = jr.init_state(0)
    N = jr.n_agents

    noise = ReplayNoise()
    _, k_env, *_ = jax.random.split(jax.random.PRNGKey(0), N + 2)
    noise.resets.append(_reset(jr, k_env, N))
    tr = OnPolicyRunner(args, algo_args, env_args, device="cpu", noise=noise)
    ts = tr.init_state(0)
    assert len(ts.actors) == len(js.actors) == (1 if updates.get("share_param") else N)
    for st, jst in zip(ts.actors, js.actors):
        st.net.load_state_dict(convert.policy_state_dict(_np(jst.params)))
    ts.critic.net.load_state_dict(convert.vnet_state_dict(_np(js.critic.params)))

    rng = js.rng
    for _ in range(iterations):
        rng = _queue_iteration(noise, jr, tr, rng)
        js, jm = jr._train_iteration(js)
        ts, tm = tr.train_iteration(ts)
        assert noise.drained()
        _close(tm["actor_stats"], jm["actor_stats"])
        for k in ("value_loss", "critic_grad_norm", "mean_step_reward", "dead_ratio",
                  "episode_return_sum", "episode_count"):
            _close(tm[k], jm[k])

    prtol, patol = ((TRPO_PARAM_RTOL, TRPO_PARAM_ATOL) if algo == "hatrpo"
                    else (PARAM_RTOL, PARAM_ATOL))
    for st, jst in zip(ts.actors, js.actors):
        ref = convert.policy_state_dict(_np(jst.params))
        for k, v in st.net.state_dict().items():
            _close(v, ref[k], prtol, patol)
    ref = convert.vnet_state_dict(_np(js.critic.params))
    for k, v in ts.critic.net.state_dict().items():
        _close(v, ref[k], PARAM_RTOL, PARAM_ATOL)
    for name in ("running_mean", "running_mean_sq", "debiasing_term"):
        _close(getattr(ts.value_norm, name), getattr(js.value_norm, name))
    _close(ts.carry.share_obs, js.carry.share_obs)

    if algo == "hatrpo":
        # every agent's line search accepted a step (the parameters moved)
        assert all(f > 0.0 for f in tm["ls_fraction"]), tm["ls_fraction"]
    if algo == "mappo":
        # one merged update: every agent reports the same stats
        assert bool((tm["actor_stats"] == tm["actor_stats"][0]).all())
    if algo == "haa2c":
        # iteration 2 of 2 ran at half the lr; the next would run at 0
        lr = algo_args["model"]["lr"]
        assert ts.actors[0].opt.adam.param_groups[0]["lr"] == pytest.approx(lr / 2, rel=1e-12)
        assert ts.actors[0].opt.lr_schedule(ts.actors[0].opt.count) == 0.0
