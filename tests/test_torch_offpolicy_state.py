"""Port parity: the whole off-policy train state carried from the JAX runner
(``convert.off_policy_state``), and an update and a collect step from a
late state.

A long HASAC run reaches states that the replayed blocks of
``tests/test_torch_runner_off_policy.py`` never do: a ring that has
wrapped, Adam counts in the tens of thousands and log α far from 0, near
its clamp at −16. Here the JAX runner's state after a warmup that wraps
its ring and one update is set to such a state (``late_state``: every Adam
count at 20,000, every log α at −6 or −16), carried into the port whole,
and one update and one collect step are held against the JAX runner's
from it, at the replay test's widths and tolerances: tuned HalfCheetah-6x1
HASAC with auto-α, ``[16, 16]``, batch 16, ``n_step`` 3.
"""
import copy

import jax
import numpy as np
import pytest
import torch

from harl_tpu.runners.off_policy import OffPolicyRunner as JRunner
from harl_tpu.utils.config_tools import get_defaults_yaml_args as jdefaults
from harl_tpu_torch.runners.off_policy import OffPolicyRunner
from harl_tpu_torch.utils import convert

from tests.test_torch_runner_off_policy import DATA_ATOL, DATA_RTOL, PARAM_ATOL, PARAM_RTOL
from tests.torch_replay import ReplayNoise, late_state, queue_collect, queue_train

B, DOF, BATCH = 4, 9, 16
RING = 40                  # the warmup's 48 rows wrap it
COUNT = 20_000
ARGS = {"algo": "hasac", "env": "mamujoco_jax", "exp_name": "parity"}


def _configs():
    algo_args, env_args = jdefaults("hasac", "mamujoco_jax")
    algo_args["train"].update(n_rollout_threads=B, warmup_steps=12 * B, train_interval=1,
                              update_per_train=1, num_env_steps=10 ** 6)
    algo_args["algo"].update(batch_size=BATCH, buffer_size=RING, n_step=3, auto_alpha=True)
    algo_args["model"].update(hidden_sizes=[16, 16])
    # episodes of 5 steps: the ring holds truncations
    env_args.update(scenario="HalfCheetah-v2", agent_conf="6x1", episode_limit=5)
    return algo_args, env_args


@pytest.fixture(scope="module")
def jax_run():
    """The JAX runner and its state after the warmup and one update."""
    algo_args, env_args = _configs()
    jr = JRunner(ARGS, copy.deepcopy(algo_args), copy.deepcopy(env_args))
    js = jr._warmup(jr.init_state(0))
    js, _ = jr._train(js)
    assert int(js.buffer.cur_size) == RING and int(js.buffer.idx) == 12 * B - RING
    return jr, js


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(noise):
    algo_args, env_args = _configs()
    return OffPolicyRunner(ARGS, algo_args, env_args, device="cpu", noise=noise)


def _close(a, b, rtol=DATA_RTOL, atol=DATA_ATOL, what=""):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(a).detach()), np.asarray(b),
                               rtol=rtol, atol=atol, err_msg=what)


def _adam_of(opt, net):
    """{name: (step, exp_avg, exp_avg_sq)} of a torch Adam over ``net``."""
    return {k: (float(opt.state[p]["step"]), opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"])
            for k, p in net.named_parameters()}


def _hold_learners(tr, ts, js, rtol, atol):
    """Every network, target, Adam state and α of the port's ``ts`` against
    the JAX state ``js``."""
    actor_sd, critic_sd = convert.off_policy_converters(tr)
    pairs = [(st.net, st.target, st.opt, jst.params, jst.target_params, jst.opt_state,
              actor_sd(i), f"actor {i}") for i, (st, jst) in enumerate(zip(ts.actors, js.actors))]
    pairs.append((ts.critic.nets, ts.critic.targets, ts.critic.opt, js.critic.params,
                  js.critic.target_params, js.critic.opt_state, critic_sd, "critic"))
    for net, target, opt, params, target_params, opt_state, to_sd, what in pairs:
        for mod, tree in ((net, params), (target, target_params)):
            ref = to_sd(_np(tree))
            for k, v in mod.state_dict().items():
                _close(v, ref[k], rtol, atol, f"{what} {k}")
        adam = opt_state[0]
        mu, nu = to_sd(_np(adam.mu)), to_sd(_np(adam.nu))
        for k, (step, m, v) in _adam_of(opt, net).items():
            assert step == int(adam.count), (what, k, step, int(adam.count))
            _close(m, mu[k], rtol, atol, f"{what} {k} mu")
            _close(v, nu[k], rtol, atol, f"{what} {k} nu")
    for st, jst, what in [(st, jst, f"actor {i}") for i, (st, jst) in
                          enumerate(zip(ts.actors, js.actors))] + [(ts.critic, js.critic,
                                                                    "critic")]:
        _close(st.log_alpha, jst.log_alpha, rtol, atol, f"{what} log α")
        a = st.alpha_opt.state[st.log_alpha]
        jopt = jst.alpha_opt_state[0]
        assert float(a["step"]) == int(jopt.count), what
        _close(a["exp_avg"], jopt.mu, rtol, atol, f"{what} α mu")
        _close(a["exp_avg_sq"], jopt.nu, rtol, atol, f"{what} α nu")


def test_the_converted_state_equals_the_jax_state(jax_run):
    jr, js = jax_run
    js = late_state(js, COUNT, -6.0)
    tr = _port(ReplayNoise())
    ts = convert.off_policy_state(tr, _np(js))
    _hold_learners(tr, ts, js, 0, 0)
    assert ts.total_it == int(js.total_it) == 1
    jb, tb = js.buffer, ts.buffer
    assert (tb.idx, tb.cur_size) == (int(jb.idx), int(jb.cur_size))
    for name in ("share_obs", "next_share_obs", "rewards", "dones", "terms"):
        assert np.array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name))), name
    for name in ("obs", "next_obs", "actions", "valid_transitions"):
        for t, j in zip(getattr(tb, name), getattr(jb, name)):
            assert np.array_equal(t.numpy(), np.asarray(j)), name
    assert tb.available_actions is None and jb.available_actions is None
    c, jc = ts.carry, js.carry
    for name in ("obs", "share_obs", "agent_deaths", "ep_ret"):
        assert np.array_equal(getattr(c, name).numpy(), np.asarray(getattr(jc, name))), name
    for name in ("q", "qd", "t"):
        t, j = getattr(c.env_state, name), np.asarray(getattr(jc.env_state, name))
        assert t.dtype == torch.from_numpy(j).dtype and np.array_equal(t.numpy(), j), name
    # into a live state: in place, the ring's storage kept
    ptr = ts.buffer.share_obs.data_ptr()
    assert convert.off_policy_state(tr, _np(late_state(js, 7, -3.0)), ts) is ts
    assert ts.buffer.share_obs.data_ptr() == ptr
    assert float(ts.actors[0].log_alpha.detach()) == -3.0
    assert float(ts.critic.opt.state[next(ts.critic.nets.parameters())]["step"]) == 7


def test_a_field_the_port_cannot_place_is_an_error(jax_run):
    jr, js = jax_run
    tr = _port(ReplayNoise())
    tree = _np(js)
    with pytest.raises(KeyError, match="rng"):
        convert.off_policy_state(tr, {k: v for k, v in tree._asdict().items() if k != "rng"})
    with pytest.raises(KeyError, match="extra"):
        convert.off_policy_state(tr, {**tree._asdict(), "extra": 0})
    with pytest.raises(KeyError, match="env state"):
        convert.off_policy_state(tr, tree._replace(carry=tree.carry._replace(
            env_state={**tree.carry.env_state._asdict(), "contact": 0})))
    with pytest.raises(KeyError, match="log α"):
        convert.off_policy_state(tr, tree._replace(critic=tree.critic._replace(log_alpha=None)))


@pytest.mark.parametrize("log_alpha", [-6.0, -16.0])
def test_an_update_and_a_collect_step_from_a_late_state_match_jax(jax_run, log_alpha):
    jr, js = jax_run
    js = late_state(js, COUNT, log_alpha)
    act_dims = [sp.shape[0] for sp in jr.act_spaces]
    noise = ReplayNoise()
    tr = _port(noise)
    ts = convert.off_policy_state(tr, _np(js))

    queue_train(noise, jr, js.rng, 1, cur_size=RING, batch=BATCH, total_it=int(js.total_it))
    j_after, jtm = jr._train(js)
    ts, ttm = tr.train_block(ts)
    assert noise.drained() and ts.total_it == int(j_after.total_it) == 2
    _close(ttm["critic_loss"], jtm["critic_loss"])
    _hold_learners(tr, ts, j_after, PARAM_RTOL, PARAM_ATOL)

    # a collect step from the same late state, the ring's head wrapping
    ts = convert.off_policy_state(tr, _np(js), ts)
    queue_collect(noise, js.rng, 1, act_dims, B, DOF)
    j_after, jcm = jr._collect(js)
    ts, tcm = tr.collect_block(ts)
    assert noise.drained()
    rows = (int(js.buffer.idx) + np.arange(B)) % RING
    jb, tb = j_after.buffer, ts.buffer
    assert (tb.idx, tb.cur_size) == (int(jb.idx), int(jb.cur_size))
    for name in ("share_obs", "next_share_obs", "rewards", "dones", "terms"):
        _close(getattr(tb, name)[rows], np.asarray(getattr(jb, name))[rows], what=name)
    for name in ("obs", "next_obs", "actions", "valid_transitions"):
        for t, j in zip(getattr(tb, name), getattr(jb, name)):
            _close(t[rows], np.asarray(j)[rows], what=name)
    for k in ("episode_return_sum", "episode_count", "mean_step_reward"):
        _close(tcm[k], jcm[k], what=k)
    for name in ("obs", "share_obs", "ep_ret", "agent_deaths"):
        _close(getattr(ts.carry, name), getattr(j_after.carry, name), what=name)
    for name in ("q", "qd"):
        _close(getattr(ts.carry.env_state, name), getattr(j_after.carry.env_state, name),
               what=name)
    assert np.array_equal(ts.carry.env_state.t.numpy(), np.asarray(j_after.carry.env_state.t))
