"""Port parity: off-policy ``share_param`` (one actor state and one Adam for
every agent), replayed against the JAX runner (``off_policy.py:156-167``).

MPE ``simple_spread`` (continuous): three homogeneous agents. Both runners
start from ``init_state(0)``; the port's gets the JAX networks through
``convert`` and every draw of the warmup, collect and train blocks through
a replaying noise source, as ``tests/test_torch_runner_off_policy.py``
does. In the sequential actor updates every agent's step moves the one
shared state, in the drawn order; the soft update then moves its one
target.
"""
import copy

import jax
import numpy as np
import pytest

from harl_tpu.runners.off_policy import OffPolicyRunner as JRunner
from harl_tpu.utils.config_tools import get_defaults_yaml_args as jdefaults
from harl_tpu_torch.runners.off_policy import OffPolicyRunner
from harl_tpu_torch.utils import convert

from tests.test_torch_runner_off_policy import BATCH
from tests.torch_replay import (ReplayNoise, mpe_reset_noise, normal, queue_train,
                                step_mpe_reset_noise, uniform)

B = 4
# the earlier off-policy runner tolerances (tests/test_torch_runner_off_policy.py)
DATA_RTOL, DATA_ATOL = 1e-4, 2e-4
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
CASES = [("hatd3", {}), ("hasac", {"auto_alpha": True})]


def _configs(algo, updates):
    algo_args, env_args = jdefaults(algo, "pettingzoo_mpe")
    algo_args["train"].update(n_rollout_threads=B, warmup_steps=2 * B, train_interval=2,
                              update_per_train=1, num_env_steps=10 ** 6)
    algo_args["algo"].update(batch_size=BATCH, buffer_size=200, share_param=True, **updates)
    algo_args["model"].update(hidden_sizes=[16, 16])
    # episodes of 3 steps: warmup and collect cross a truncation in every env
    env_args.update(scenario="simple_spread_v2", continuous_actions=True, max_cycles=3)
    return algo_args, env_args


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(a, b, rtol=DATA_RTOL, atol=DATA_ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _queue_steps(noise, rng, steps, act_dims, n_agents, queue, draw):
    """The draws of ``steps`` warmup (uniform) or collect (normal) steps."""
    rng, k = jax.random.split(rng)
    for kk in jax.random.split(k, steps):
        k1, k2 = jax.random.split(kk)
        for i, d in enumerate(act_dims):
            queue.append(draw(jax.random.fold_in(k1, i), (B, d)))
        noise.resets.append(step_mpe_reset_noise(k2, B, n_agents, False))
    return rng


@pytest.mark.parametrize("algo,updates", CASES, ids=[a for a, _ in CASES])
def test_share_param_blocks_match_jax(algo, updates):
    algo_args, env_args = _configs(algo, updates)
    args = {"algo": algo, "env": "pettingzoo_mpe", "exp_name": "parity"}
    jr = JRunner(args, copy.deepcopy(algo_args), copy.deepcopy(env_args))
    js = jr.init_state(0)
    N = jr.n_agents
    act_dims = [sp.shape[0] for sp in jr.act_spaces]
    assert N == 3 and len(js.actors) == 1

    noise = ReplayNoise()
    _, k_env, *_ = jax.random.split(jax.random.PRNGKey(0), N + 3)
    noise.resets.append(mpe_reset_noise(jax.random.split(k_env, B), N, False))
    tr = OffPolicyRunner(args, algo_args, env_args, device="cpu", noise=noise)
    ts = tr.init_state(0)
    assert len(ts.actors) == 1 and tr.actors[0] is tr.actors[2]
    to_sd = (convert.squashed_policy_state_dict if algo == "hasac"
             else convert.deterministic_policy_state_dict)
    (st,), (jst,) = ts.actors, js.actors
    st.net.load_state_dict(to_sd(_np(jst.params)))
    st.target.load_state_dict(to_sd(_np(jst.target_params)))
    ts.critic.nets.load_state_dict(convert.q_nets_state_dict(_np(js.critic.params)))
    ts.critic.targets.load_state_dict(convert.q_nets_state_dict(_np(js.critic.target_params)))

    rng = _queue_steps(noise, js.rng, 2, act_dims, N, noise.uniforms, uniform)
    rng = _queue_steps(noise, rng, 2, act_dims, N, noise.actions, normal)
    queue_train(noise, jr, rng, 2, cur_size=4 * B, batch=BATCH)

    js = jr.warmup_block(js)
    js, jcm = jr.collect_block(js)
    js, jtm = jr.train_block(js)
    ts = tr.warmup_block(ts)
    ts, tcm = tr.collect_block(ts)
    rows = ts.buffer.cur_size
    assert rows == int(js.buffer.cur_size) == 4 * B
    for name in ("obs", "actions", "next_obs"):
        for t, j in zip(getattr(ts.buffer, name), getattr(js.buffer, name)):
            _close(t[:rows], j[:rows])
    for name in ("share_obs", "rewards", "dones", "terms"):
        _close(getattr(ts.buffer, name)[:rows], getattr(js.buffer, name)[:rows])
    for k in ("episode_return_sum", "episode_count", "mean_step_reward"):
        _close(tcm[k], jcm[k])

    ts, ttm = tr.train_block(ts)
    assert noise.drained()
    assert ts.total_it == int(js.total_it) == 2
    _close(ttm["critic_loss"], jtm["critic_loss"])
    (st,), (jst,) = ts.actors, js.actors
    for net, params in ((st.net, jst.params), (st.target, jst.target_params)):
        ref = to_sd(_np(params))
        for k, v in net.state_dict().items():
            _close(v, ref[k], PARAM_RTOL, PARAM_ATOL)
    if updates.get("auto_alpha"):
        _close(st.log_alpha.detach(), jst.log_alpha, PARAM_RTOL, PARAM_ATOL)
        _close(ts.critic.log_alpha.detach(), js.critic.log_alpha, PARAM_RTOL, PARAM_ATOL)
    for nets, params in ((ts.critic.nets, js.critic.params),
                         (ts.critic.targets, js.critic.target_params)):
        ref = convert.q_nets_state_dict(_np(params))
        for k, v in nets.state_dict().items():
            _close(v, ref[k], PARAM_RTOL, PARAM_ATOL)


def test_share_param_needs_homogeneous_agents():
    algo_args, env_args = _configs("hatd3", {})
    env_args.update(scenario="simple_speaker_listener_v3")
    with pytest.raises(ValueError, match="homogeneous"):
        OffPolicyRunner({"algo": "hatd3", "env": "pettingzoo_mpe"}, algo_args, env_args,
                        device="cpu")
