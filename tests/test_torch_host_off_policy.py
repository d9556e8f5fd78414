"""Port parity: the off-policy host path (``_host_steps``, off_policy.py:
809-897) for a warmup and an exploration block, then a train block,
replayed against the JAX runner on HalfCheetah-2x3 on the native engine;
and HAD3QN's host steps on a stub env whose availability changes at reset
and whose agents disagree on ``bad_transition``, which pins two things the
port copies from JAX: the availability after an auto-reset is stored as
the transition's next one, and truncation is read from agent 0's info.

Both runners step their own native engines, seeded alike. The port's
runner gets the JAX networks through ``convert`` and, through a replaying
noise source, the draws of the JAX host steps (each step splits the rng
three ways and agent i draws from ``fold_in(k1, i)``: the warmup's
uniforms, the exploration normals) and of the train block (the draws of
``tests/test_torch_runner_off_policy.py``).

The warmup's rows are bitwise equal: the uniform actions are, and the same
engine steps the same controls. The exploration actions come from the
networks, whose sums differ from JAX's in the last bits, so those rows
are held at the data tolerance.
"""
import copy

import jax
import numpy as np
import pytest

import harl_tpu.envs
import harl_tpu_torch.envs
from harl_tpu.runners.off_policy import OffPolicyRunner as JRunner
from harl_tpu.utils.config_tools import get_defaults_yaml_args as jdefaults
from harl_tpu_torch.envs.mamujoco.native_vec import NativeMAMuJoCoVec
from harl_tpu_torch.runners.off_policy import OffPolicyRunner
from harl_tpu_torch.utils import convert
from harl_tpu_torch.utils.spaces import Box, Discrete

from tests.test_torch_runner_off_policy import BATCH
from tests.torch_replay import (ReplayNoise, queue_host_off_policy_steps, queue_train, randint,
                                uniform)

B, WARM, EXPLORE = 4, 2, 2
DATA_RTOL, DATA_ATOL = 1e-4, 2e-4
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
ENV_ARGS = {"scenario": "HalfCheetah-v2", "agent_conf": "2x3", "episode_limit": 3,
            "backend": "native"}


def _configs(algo):
    algo_args, env_args = jdefaults(algo, "mamujoco")
    algo_args["train"].update(n_rollout_threads=B, warmup_steps=WARM * B,
                              train_interval=EXPLORE, update_per_train=1, num_env_steps=10 ** 6)
    algo_args["algo"].update(batch_size=BATCH, buffer_size=200)
    if algo == "hasac":
        algo_args["algo"]["n_step"] = 3
    algo_args["model"].update(hidden_sizes=[16, 16])
    # episodes of 3 steps: every env truncates once in the 4 steps
    env_args.update(ENV_ARGS)
    return algo_args, env_args


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(a, b, rtol=DATA_RTOL, atol=DATA_ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _policy_sd(algo):
    return (convert.squashed_policy_state_dict if algo == "hasac"
            else convert.deterministic_policy_state_dict)


def _columns(buf):
    """The buffer's columns by name: env-level tensors and per-agent lists."""
    cols = {k: [getattr(buf, k)] for k in ("share_obs", "next_share_obs", "rewards", "dones",
                                           "terms")}
    cols.update({k: list(getattr(buf, k)) for k in ("obs", "next_obs", "actions",
                                                    "valid_transitions")})
    return cols


@pytest.mark.parametrize("algo", ["hatd3", "hasac"])
def test_host_steps_and_train_block_match_jax(algo):
    algo_args, env_args = _configs(algo)
    args = {"algo": algo, "env": "mamujoco", "exp_name": "parity"}
    jr = JRunner(args, copy.deepcopy(algo_args), copy.deepcopy(env_args))
    js = jr.init_state(0)
    noise = ReplayNoise()
    tr = OffPolicyRunner(args, algo_args, env_args, device="cpu", noise=noise)
    assert tr.host_mode and isinstance(tr.vec, NativeMAMuJoCoVec)
    ts = tr.init_state(0)
    to_sd = _policy_sd(algo)
    for st, jst in zip(ts.actors, js.actors):
        st.net.load_state_dict(to_sd(_np(jst.params)))
        st.target.load_state_dict(to_sd(_np(jst.target_params)))
    ts.critic.nets.load_state_dict(convert.q_nets_state_dict(_np(js.critic.params)))
    ts.critic.targets.load_state_dict(convert.q_nets_state_dict(_np(js.critic.target_params)))
    np.testing.assert_array_equal(ts.carry.obs.numpy(), np.asarray(js.carry.obs))

    dims = [sp.shape[0] for sp in jr.act_spaces]
    rng = queue_host_off_policy_steps(noise, js.rng, WARM, [("uniform", (B, d)) for d in dims])
    rng = queue_host_off_policy_steps(noise, rng, EXPLORE, [("normal", (B, d)) for d in dims])
    queue_train(noise, jr, rng, EXPLORE, cur_size=(WARM + EXPLORE) * B, batch=BATCH)

    js, _ = jr._host_steps(js, WARM, explore="random")
    js, jcm = jr._host_steps(js, EXPLORE, explore=True)
    js, jtm = jr._train(js)
    ts = tr.warmup_block(ts)
    ts, tcm = tr.collect_block(ts)
    rows = ts.buffer.cur_size
    assert rows == int(js.buffer.cur_size) == (WARM + EXPLORE) * B
    warm = WARM * B
    tcols, jcols = _columns(ts.buffer), _columns(js.buffer)
    for name, tlist in tcols.items():
        for t, j in zip(tlist, jcols[name]):
            np.testing.assert_array_equal(t[:warm].numpy(), np.asarray(j[:warm]), err_msg=name)
            _close(t[warm:rows], j[warm:rows])
    # every env truncated once: dones without terms
    assert float(ts.buffer.dones.sum()) == B and float(ts.buffer.terms.sum()) == 0
    for k in ("episode_return_sum", "episode_count", "mean_step_reward"):
        _close(tcm[k], jcm[k])
    _close(ts.carry.obs, js.carry.obs)
    _close(ts.carry.ep_ret, js.carry.ep_ret)
    np.testing.assert_array_equal(ts.carry.agent_deaths.numpy(), np.asarray(js.carry.agent_deaths))

    ts, ttm = tr.train_block(ts)
    assert noise.drained()
    assert ts.total_it == int(js.total_it) == EXPLORE
    _close(ttm["critic_loss"], jtm["critic_loss"])
    for st, jst in zip(ts.actors, js.actors):
        for net, params in ((st.net, jst.params), (st.target, jst.target_params)):
            ref = to_sd(_np(params))
            for k, v in net.state_dict().items():
                _close(v, ref[k], PARAM_RTOL, PARAM_ATOL)
    for nets, params in ((ts.critic.nets, js.critic.params),
                         (ts.critic.targets, js.critic.target_params)):
        ref = convert.q_nets_state_dict(_np(params))
        for k, v in nets.state_dict().items():
            _close(v, ref[k], PARAM_RTOL, PARAM_ATOL)

    # the deterministic host evaluation: fresh envs seeded from 50000, until
    # three episodes have ended
    _close(tr.host_eval(ts, 3), jr.host_eval(js, 3))


class SwitchingHostEnv:
    """A host env (the 6-tuple protocol) of two agents with three actions.
    Env k (seeded 1 + 1000·k by the vec env) plays episodes of 2 + k mod 2
    steps, agent 1 done a step before the env; its availability after a
    reset, ``RESET_AVAIL``, is none of those within an episode; at each
    episode's end its agents disagree on ``bad_transition``: agent 0 false
    and agent 1 true where the episode's number plus k is odd, the reverse
    where it is even."""

    is_jax = False
    n_agents = 2
    RESET_AVAIL = np.array([[1, 1, 0], [0, 1, 1]], np.float32)

    def __init__(self):
        self.observation_space = [Box((-10.0,) * 4, (10.0,) * 4)] * 2
        self.share_observation_space = [Box((-10.0,) * 5, (10.0,) * 5)] * 2
        self.action_space = [Discrete(3)] * 2
        self.k = self.t = self.episode = 0

    def seed(self, seed):
        self.k = seed // 1000

    def _obs(self, moved=0.0):
        x = self.k + 0.1 * self.episode + 0.01 * self.t + moved
        obs = np.stack([np.linspace(x, x + i + 1, 4, dtype=np.float32) for i in range(2)])
        # an env-level state: the JAX host path keeps no agent axis here
        return obs, np.arange(5, dtype=np.float32) + x

    def reset(self):
        self.t, self.episode = 0, self.episode + 1
        return (*self._obs(), self.RESET_AVAIL.copy())

    def step(self, actions):
        self.t += 1
        a = np.asarray(actions, np.float32).reshape(2, -1)[:, 0]
        length = 2 + self.k % 2
        end, odd = self.t >= length, (self.episode + self.k) % 2 == 1
        avail = np.array([[1, 0, 1], [1, 1, 0]] if self.t % 2 else [[0, 1, 1], [1, 0, 1]],
                         np.float32)
        return (*self._obs(0.5 * float(a.sum())),
                np.full((2, 1), float(a @ [1.0, 2.0]) - self.t, np.float32),
                np.array([end, self.t >= length - 1]),
                [{"bad_transition": end and not odd}, {"bad_transition": end and odd}], avail)


def test_host_steps_keep_reset_availability_and_agent0_truncation(monkeypatch):
    """HAD3QN's warmup and exploration host steps on ``SwitchingHostEnv``,
    the port against the JAX runner from the same networks and draws: the
    ring's rows equal exactly, every column; where an env ended, the next
    availability stored is the reset's and the row terminates exactly where
    agent 0 did not call the end a truncation (both orders occur)."""
    for pkg in (harl_tpu.envs, harl_tpu_torch.envs):   # the vec envs' other envs
        monkeypatch.setattr(pkg, "make_env", lambda *a, **k: SwitchingHostEnv())
    algo_args, env_args = jdefaults("had3qn", "pettingzoo_mpe")
    algo_args["train"].update(n_rollout_threads=B, warmup_steps=WARM * B,
                              train_interval=EXPLORE, num_env_steps=10 ** 6)
    algo_args["algo"].update(batch_size=BATCH, buffer_size=200, base_hidden_sizes=[16, 16],
                             dueling_v_hidden_sizes=[8], dueling_a_hidden_sizes=[8])
    args = {"algo": "had3qn", "env": "stub", "exp_name": "parity"}
    jr = JRunner(args, copy.deepcopy(algo_args), dict(env_args), env=SwitchingHostEnv())
    js = jr.init_state(0)
    noise = ReplayNoise()
    tr = OffPolicyRunner(args, algo_args, dict(env_args), device="cpu", noise=noise,
                         env=SwitchingHostEnv())
    assert tr.host_mode and jr.host_mode
    ts = tr.init_state(0)
    for st, jst in zip(ts.actors, js.actors):
        st.net.load_state_dict(convert.dueling_q_state_dict(_np(jst.params)))
        st.target.load_state_dict(convert.dueling_q_state_dict(_np(jst.target_params)))
    rng = queue_host_off_policy_steps(noise, js.rng, WARM, [("randint", (B, 1), 3)] * 2)
    for _ in range(EXPLORE):   # ε-greedy: agent i's randint, then its coin
        rng, k1, _ = jax.random.split(rng, 3)
        for i in range(2):
            ka, kb = jax.random.split(jax.random.fold_in(k1, i))
            noise.ints.append((3, randint(ka, (B, 1), 3)))
            noise.uniforms.append(uniform(kb, (B, 1)))

    js, _ = jr._host_steps(js, WARM, explore="random")
    js, _ = jr._host_steps(js, EXPLORE, explore=True)
    ts = tr.warmup_block(ts)
    ts, _ = tr.collect_block(ts)
    assert noise.drained()
    rows = ts.buffer.cur_size
    assert rows == int(js.buffer.cur_size) == (WARM + EXPLORE) * B
    tb, jb = ts.buffer, js.buffer
    for name in ("share_obs", "next_share_obs", "rewards", "dones", "terms", "obs", "next_obs",
                 "actions", "valid_transitions", "available_actions", "next_available_actions"):
        for t, j in zip(*((x,) if name in ("share_obs", "next_share_obs", "rewards", "dones",
                                           "terms") else x
                          for x in (getattr(tb, name), getattr(jb, name)))):
            np.testing.assert_array_equal(t[:rows].numpy(), np.asarray(j[:rows]), err_msg=name)
    # rows are step-major: row s·B + k is env k's step s + 1
    ended = tb.dones[:rows, 0].numpy() == 1
    steps, envs = np.divmod(np.arange(rows), B)
    assert ended.sum() == 6      # envs 0 and 2 end at steps 2 and 4, envs 1 and 3 at step 3
    for i in range(2):
        np.testing.assert_array_equal(tb.next_available_actions[i][:rows].numpy()[ended],
                                      np.tile(SwitchingHostEnv.RESET_AVAIL[i], (6, 1)))
    # an episode's number at its end: env k's first ends at step 2 + k mod 2
    episode = 1 + (steps[ended] + 1 > 2 + envs[ended] % 2)
    agent0_bad = (episode + envs[ended]) % 2 == 0
    np.testing.assert_array_equal(tb.terms[:rows, 0].numpy()[ended], (~agent0_bad).astype(
        np.float32))
    assert 0 < agent0_bad.sum() < 6
