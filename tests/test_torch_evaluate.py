"""Port parity: ``evaluate`` of both runners against the JAX runners'
evaluation, and evaluation leaving training alone.

The JAX ``eval_rollout`` derives round r's draws from
``fold_in(fold_in(rng, 7777), r)`` (on-policy; 31337 off-policy): the eval
envs' reset keys, then each step's key, whose split gives the reset draws
of the auto-reset. The port takes each round's draws from ``eval_noise(r)``;
here that returns a replaying noise source holding the JAX draws. Actions
are deterministic on both sides, so nothing else is drawn.
"""
import copy

import jax
import numpy as np
import pytest
import torch

from harl_tpu.runners.off_policy import OffPolicyRunner as JOffRunner
from harl_tpu.runners.on_policy import OnPolicyRunner as JRunner
from harl_tpu.utils.config_tools import get_defaults_yaml_args as jdefaults
from harl_tpu_torch.runners.off_policy import OffPolicyRunner
from harl_tpu_torch.runners.on_policy import OnPolicyRunner
from harl_tpu_torch.utils import convert
from harl_tpu_torch.utils.config_tools import get_defaults_yaml_args

from tests.torch_replay import (ReplayNoise, reset_noise, smaclite_reset_noise,
                                step_reset_noise, step_smaclite_reset_noise)

DOF, N_EVAL, EPISODES = 9, 3, 5
# returns summed over a few float32 physics steps (tests/test_torch_runner.py)
RTOL, ATOL = 1e-4, 2e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _eval_draws(rng, salt, n_rounds, steps, smac):
    """One replaying noise source per round, holding the JAX round's draws."""
    out = []
    for r in range(n_rounds):
        key = jax.random.fold_in(jax.random.fold_in(rng, salt), r)
        noise = ReplayNoise()
        noise.resets.append(smaclite_reset_noise(jax.random.split(key, N_EVAL), 3, 3) if smac
                            else reset_noise(jax.random.split(key, N_EVAL), DOF))
        for k in jax.random.split(key, steps):
            noise.resets.append(step_smaclite_reset_noise(k, N_EVAL, 3, 3) if smac
                                else step_reset_noise(k, N_EVAL, DOF))
        out.append(noise)
    return out


def _on_policy_configs(env):
    algo_args, env_args = jdefaults("happo", env)
    algo_args["train"].update(n_rollout_threads=2, episode_length=4, num_env_steps=8)
    algo_args["model"].update(hidden_sizes=[16, 16])
    if env == "smaclite":
        algo_args["model"].update(use_recurrent_policy=True, data_chunk_length=2)
        env_args.update(map_name="3m", state_type="FP", episode_limit=6)
    else:
        env_args.update(scenario="HalfCheetah-v2", agent_conf="2x3", episode_limit=4)
    return algo_args, env_args


@pytest.mark.parametrize("env", ["mamujoco_jax", "smaclite"])
def test_on_policy_evaluate_matches_jax(env):
    algo_args, env_args = _on_policy_configs(env)
    args = {"algo": "happo", "env": env, "exp_name": "parity"}
    jr = JRunner(args, copy.deepcopy(algo_args), copy.deepcopy(env_args))
    js = jr.init_state(0)
    tr = OnPolicyRunner(args, algo_args, env_args, device="cpu")
    ts = tr.init_state(0)
    for st, jst in zip(ts.actors, js.actors):
        st.net.load_state_dict(convert.policy_state_dict(_np(jst.params)))
    steps = tr._eval_len()
    assert steps == jr._eval_len() == env_args["episode_limit"]
    rounds = _eval_draws(js.rng, 7777, 2, steps, env == "smaclite")
    tr.eval_noise = lambda r: rounds[r]

    for r in range(2):   # the round sums
        jsum, jcnt, jm = jr.eval_rollout(js, N_EVAL, r)
        tsum, tcnt, tm = tr.eval_rollout(ts, N_EVAL, r)
        assert float(tcnt) == float(jcnt) >= N_EVAL
        np.testing.assert_allclose(float(tsum), float(jsum), rtol=RTOL, atol=ATOL)
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL, atol=ATOL)
        assert rounds[r].drained()
    rounds[:] = _eval_draws(js.rng, 7777, 2, steps, env == "smaclite")
    jret, jextra = jr.evaluate(js, N_EVAL, EPISODES)   # two rounds: 6 episodes >= 5
    tret, textra = tr.evaluate(ts, N_EVAL, EPISODES)
    assert np.isfinite(tret)
    np.testing.assert_allclose(tret, jret, rtol=RTOL, atol=ATOL)
    assert set(textra) == set(jextra)
    if env == "smaclite":
        assert "won" in textra


@pytest.mark.parametrize("algo", ["hasac", "hatd3"])
def test_off_policy_evaluate_matches_jax(algo):
    algo_args, env_args = jdefaults(algo, "mamujoco_jax")
    algo_args["train"].update(n_rollout_threads=2, warmup_steps=4, train_interval=2)
    algo_args["algo"].update(batch_size=8, buffer_size=50)
    algo_args["model"].update(hidden_sizes=[16, 16])
    env_args.update(scenario="HalfCheetah-v2", agent_conf="2x3", episode_limit=4)
    args = {"algo": algo, "env": "mamujoco_jax", "exp_name": "parity"}
    jr = JOffRunner(args, copy.deepcopy(algo_args), copy.deepcopy(env_args))
    js = jr.init_state(0)
    tr = OffPolicyRunner(args, algo_args, env_args, device="cpu")
    ts = tr.init_state(0)
    to_sd = (convert.squashed_policy_state_dict if algo == "hasac"
             else convert.deterministic_policy_state_dict)
    for st, jst in zip(ts.actors, js.actors):
        st.net.load_state_dict(to_sd(_np(jst.params)))
    rounds = _eval_draws(js.rng, 31337, 2, tr._eval_len(), False)
    tr.eval_noise = lambda r: rounds[r]
    jret, _ = jr.evaluate(js, N_EVAL, EPISODES)
    tret, _ = tr.evaluate(ts, N_EVAL, EPISODES)
    assert all(n.drained() for n in rounds)
    np.testing.assert_allclose(tret, jret, rtol=RTOL, atol=ATOL)


def _params(nets):
    return [p.detach().clone() for net in nets for p in net.parameters()]


def test_on_policy_eval_leaves_training_alone():
    """Evaluation draws from generators of its own: a run with eval on
    trains bitwise as a run with eval off."""
    finals = []
    for use_eval in (True, False):
        algo_args, env_args = get_defaults_yaml_args("happo", "mamujoco_jax")
        algo_args["train"].update(n_rollout_threads=2, episode_length=4, num_env_steps=24,
                                  eval_interval=1, log_interval=1)
        algo_args["model"].update(hidden_sizes=[8, 8])
        algo_args["eval"].update(use_eval=use_eval, n_eval_rollout_threads=2, eval_episodes=2)
        env_args.update(agent_conf="2x3", episode_limit=3)
        runner = OnPolicyRunner({"algo": "happo", "env": "mamujoco_jax"}, algo_args, env_args,
                                device="cpu")
        state, history = runner.run(seed=3)
        assert ("eval_return" in history[-1]) == use_eval
        finals.append(_params([a.net for a in state.actors] + [state.critic.net]))
    for a, b in zip(*finals):
        assert torch.equal(a, b)


def test_off_policy_eval_leaves_training_alone():
    finals = []
    for use_eval in (True, False):
        algo_args, env_args = get_defaults_yaml_args("hasac", "mamujoco_jax")
        algo_args["train"].update(n_rollout_threads=2, warmup_steps=4, train_interval=2,
                                  num_env_steps=16, eval_interval=2)
        algo_args["algo"].update(batch_size=8, buffer_size=50)
        algo_args["model"].update(hidden_sizes=[8, 8])
        algo_args["eval"].update(use_eval=use_eval, n_eval_rollout_threads=2, eval_episodes=2)
        env_args.update(agent_conf="2x3", episode_limit=3)
        runner = OffPolicyRunner({"algo": "hasac", "env": "mamujoco_jax"}, algo_args, env_args,
                                 device="cpu")
        state, history = runner.run(seed=3)
        assert len(history) == 4 and ("eval_return" in history[-1]) == use_eval
        finals.append(_params([a.net for a in state.actors] + [state.critic.nets]))
    for a, b in zip(*finals):
        assert torch.equal(a, b)
