"""Port parity: the off-policy FP path — the FP replay buffer, the critic's
and the actor objectives' FP tiling, and a replayed FP HASAC block.

* The buffer: steps of several threads with per-agent deaths inside
  episodes, episode ends and truncations go into a ring that wraps; the
  per-agent end flags and the FP n-step samples from the same injected
  starts equal the JAX buffer's exactly (rows, flags, dones, terms), with
  rewards and γⁿ at 1e-6.
* The critic's TD step and HASAC/HATD3 actor updates on an FP sample
  (agent-major state rows), from converted parameters.
* Warmup, collect and train of FP HASAC on SMACLite ``3m`` against the JAX
  runner, every draw replayed (``tests/torch_replay.py``).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harl_tpu.algos import q_critics as jq
from harl_tpu.buffers import off_policy as jbuf
from harl_tpu.buffers.off_policy import Sample as JSample
from harl_tpu.runners.off_policy import OffPolicyRunner as JRunner
from harl_tpu.utils import spaces as jspaces
from harl_tpu.utils.config_tools import get_defaults_yaml_args as jdefaults
from harl_tpu_torch.algos import q_critics as tq
from harl_tpu_torch.buffers import off_policy as tbuf
from harl_tpu_torch.buffers.off_policy import Sample
from harl_tpu_torch.runners.off_policy import OffPolicyRunner
from harl_tpu_torch.utils import convert, spaces

from tests.torch_replay import (ReplayNoise, gumbel_noise, normal, randint, reset_noise,
                                smaclite_reset_noise, step_smaclite_reset_noise)

S, B, N, DS, OBS, ACT = 60, 4, 3, 5, (4, 2, 3), (2, 1, 3)
GAMMA = 0.99
# the replayed block: the tolerances of the EP blocks
# (test_torch_runner_off_policy.py)
DATA_RTOL, DATA_ATOL = 1e-4, 2e-4
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(a, b, rtol=PARAM_RTOL, atol=PARAM_ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _equal(t, j):
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


# ------------------------------------------------------------------ buffer
def _steps(n_steps, seed):
    """One dict of numpy arrays per vectorised FP step. Episodes end with
    probability 0.15 (a truncation in a third of them), and inside an
    episode an agent dies with probability 0.1 and stays dead, so the agents'
    end flags differ."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    dead = np.zeros((B, N), bool)
    out = []
    for _ in range(n_steps):
        end = rng.random(B) < 0.15
        dead |= rng.random((B, N)) < 0.1
        dones = (dead | end[:, None]).astype(np.float32)[..., None]
        trunc = end & (rng.random(B) < 0.33)
        terms = dones * (1.0 - trunc.astype(np.float32))[:, None, None]
        out.append(dict(
            share_obs=f(B, N, DS), next_share_obs=f(B, N, DS), rewards=f(B, N, 1),
            dones=dones, terms=terms.astype(np.float32),
            obs=[f(B, d) for d in OBS], next_obs=[f(B, d) for d in OBS],
            actions=[f(B, d) for d in ACT],
            valid_transitions=[(~dead[:, i:i + 1]).astype(np.float32) for i in range(N)],
            available_actions=[(rng.random((B, d + 2)) < 0.7).astype(np.float32) for d in ACT],
            next_available_actions=[(rng.random((B, d + 2)) < 0.7).astype(np.float32)
                                    for d in ACT]))
        dead[end] = False
    return out


def _fill(n_steps, seed=0):
    avail = [d + 2 for d in ACT]
    jb = jbuf.init_buffer_fp(S, N, DS, list(OBS), list(ACT), avail)
    tb = tbuf.ReplayBufferFP(S, N, DS, OBS, ACT, device="cpu", avail_dims=avail)
    for step in _steps(n_steps, seed):
        jb = jbuf.insert(jb, {k: tuple(jnp.asarray(x) for x in v) if isinstance(v, list)
                              else jnp.asarray(v) for k, v in step.items()})
        tb.insert({k: [torch.from_numpy(x) for x in v] if isinstance(v, list)
                   else torch.from_numpy(v) for k, v in step.items()})
    return jb, tb


def _jax_end_flag(jb):
    """The per-agent end flags of ``sample_fp`` (buffers/off_policy.py:235-240)."""
    cur = jnp.maximum(jb.cur_size, 1)
    unfinished = (jb.idx - jnp.arange(B) - 1 + cur) % cur
    return (jb.dones[..., 0] > 0).at[unfinished, :].set(True)


@pytest.mark.parametrize("n_steps", [6, 15, 22])   # part full, full, wrapped
def test_fp_insert_and_end_flags_match_jax(n_steps):
    jb, tb = _fill(n_steps)
    assert (tb.idx, tb.cur_size) == (int(jb.idx), int(jb.cur_size))
    assert tuple(tb.share_obs.shape) == (S, N, DS) and tuple(tb.rewards.shape) == (S, N, 1)
    for name in ("share_obs", "next_share_obs", "rewards", "dones", "terms"):
        _equal(getattr(tb, name), getattr(jb, name))
    for name in ("obs", "next_obs", "actions", "valid_transitions", "available_actions",
                 "next_available_actions"):
        for t, j in zip(getattr(tb, name), getattr(jb, name)):
            _equal(t, j)
    flags = tb.end_flag(B)
    _equal(flags, _jax_end_flag(jb))
    # the agents' end flags differ on some rows: each agent walks its own
    assert bool((flags != flags[:, :1]).any())


@pytest.mark.parametrize("n_step", [1, 5, 20])
@pytest.mark.parametrize("n_steps", [9, 22])
def test_fp_sample_matches_jax(n_step, n_steps):
    """Every start of the rows written, each agent walked ``n_step`` steps:
    indices, flags, dones and terms exact; rewards and γⁿ at 1e-6."""
    jb, tb = _fill(n_steps, seed=n_step)
    start = np.arange(tb.cur_size)
    batch = len(start)
    js = jbuf.sample_fp(jb, None, batch, n_step, GAMMA, B, start=jnp.asarray(start))
    ts = tb.sample(batch, n_step, GAMMA, B, start=torch.from_numpy(start))
    for name in ("share_obs", "dones", "terms", "next_share_obs"):
        assert tuple(getattr(ts, name).shape)[0] == N * batch
        _equal(getattr(ts, name), getattr(js, name))
    for name in ("rewards", "gamma"):
        _close(getattr(ts, name), getattr(js, name), 1e-6, 1e-6)
    for name in ("obs", "actions", "valid_transitions", "next_obs", "available_actions",
                 "next_available_actions"):
        for t, j in zip(getattr(ts, name), getattr(js, name)):
            _equal(t, j)
    if n_step > 1:
        g = ts.gamma.reshape(N, batch)
        # walks stopped early at deaths, ends and the unfinished heads, and
        # the agents' walks differ
        assert len(np.unique(g.numpy())) > 1 and bool((g != g[:1]).any())


def test_fp_sample_draws_starts_from_the_noise_source():
    _, tb = _fill(5)

    class Starts:
        def indices(self, n, high):
            assert (n, high) == (8, tb.cur_size)
            return torch.arange(n)

    ts = tb.sample(8, 3, GAMMA, B, noise=Starts())
    _equal(ts.share_obs[:8], tb.share_obs[:8, 0])
    _equal(ts.share_obs[8:16], tb.share_obs[:8, 1])


# ------------------------------------------------------------------ critic
BATCH, HIDDEN = 16, [16, 16]


def _fp_sample(seed, ds, obs_dims, act_dims, n=N, avail=None):
    """(JAX Sample, port Sample) of the same random FP rows: env-level
    fields (n·BATCH, ·) agent-major, per-agent fields (BATCH, ·)."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    rows = n * BATCH
    dones = (rng.random((rows, 1)) < 0.3).astype(np.float32)
    d = dict(share_obs=f(rows, ds), next_share_obs=f(rows, ds), rewards=f(rows, 1),
             dones=dones, terms=dones * (rng.random((rows, 1)) < 0.5).astype(np.float32),
             gamma=(0.99 ** rng.integers(1, 4, (rows, 1))).astype(np.float32),
             obs=[f(BATCH, k) for k in obs_dims], next_obs=[f(BATCH, k) for k in obs_dims],
             actions=[np.tanh(f(BATCH, k)) for k in act_dims],
             valid_transitions=[(rng.random((BATCH, 1)) < 0.7).astype(np.float32)
                                for _ in obs_dims])
    js = JSample(available_actions=None, next_available_actions=None,
                 **{k: tuple(map(jnp.asarray, v)) if isinstance(v, list) else jnp.asarray(v)
                    for k, v in d.items()})
    ts = Sample(**{k: [torch.from_numpy(x) for x in v] if isinstance(v, list)
                   else torch.from_numpy(v) for k, v in d.items()})
    return js, ts


@pytest.mark.parametrize("name,cfg", [
    ("SoftTwinContinuousQCritic", dict(use_valuenorm=True)),
    ("SoftTwinContinuousQCritic", dict(use_valuenorm=False, use_policy_active_masks=False)),
    ("TwinContinuousQCritic", dict(use_huber_loss=False)),
], ids=["soft-masked-valuenorm", "soft-unmasked", "twin"])
def test_fp_critic_train_matches_jax(name, cfg):
    """Two TD steps on FP samples: the joint actions, next joint actions and
    next log-probabilities tiled over the agent-major rows, and the soft
    critic's loss averaged over valid transitions."""
    cfg = dict(critic_lr=5e-4, polyak=0.005, hidden_sizes=HIDDEN, huber_delta=10.0,
               alpha_lr=3e-4, _fp_agents=N, **cfg)
    jc = getattr(jq, name)(DS, [jspaces.Box.create(-1.0, 1.0, d) for d in ACT], cfg)
    tc = getattr(tq, name)(DS, [spaces.Box.create(-1.0, 1.0, d) for d in ACT], cfg,
                           device="cpu")
    js = jc.init(jax.random.PRNGKey(0))
    ts = tc.init()
    ts.nets.load_state_dict(convert.q_nets_state_dict(_np(js.params)))
    ts.targets.load_state_dict(convert.q_nets_state_dict(_np(js.target_params)))
    for step in range(2):
        jsp, tsp = _fp_sample(10 + step, DS, OBS, ACT)
        rng = np.random.default_rng(20 + step)
        next_joint = np.tanh(rng.standard_normal((BATCH, sum(ACT)))).astype(np.float32)
        next_logp = rng.standard_normal((BATCH, 1)).astype(np.float32)
        if tc.soft:
            js, jloss = jc.train(js, jsp, jnp.asarray(next_joint), jnp.asarray(next_logp),
                                 jnp.asarray(0.2))
            tloss = tc.train(ts, tsp, torch.from_numpy(next_joint),
                             torch.from_numpy(next_logp), 0.2)
        else:
            js, jloss = jc.train(js, jsp, jnp.asarray(next_joint))
            tloss = tc.train(ts, tsp, torch.from_numpy(next_joint))
        _close(tloss, jloss, LOSS_RTOL, LOSS_ATOL)
    ref = convert.q_nets_state_dict(_np(js.params))
    for k, v in ts.nets.state_dict().items():
        _close(v, ref[k])


def _planar_runners(algo):
    """The two runners on HalfCheetah 2x3, switched to the FP forms of their
    actor objectives and critic (an FP sample's rows are agent-major)."""
    algo_args, env_args = jdefaults(algo, "mamujoco_jax")
    algo_args["train"].update(n_rollout_threads=2)
    algo_args["algo"].update(batch_size=BATCH, buffer_size=100)
    algo_args["model"].update(hidden_sizes=HIDDEN)
    env_args.update(scenario="HalfCheetah-v2", agent_conf="2x3")
    args = {"algo": algo, "env": "mamujoco_jax"}
    jr = JRunner(args, copy.deepcopy(algo_args), copy.deepcopy(env_args))
    js = jr.init_state(0)
    noise = ReplayNoise()
    _, k_env, *_ = jax.random.split(jax.random.PRNGKey(0), jr.n_agents + 3)
    noise.resets.append(reset_noise(jax.random.split(k_env, 2), 9))
    tr = OffPolicyRunner(args, algo_args, env_args, device="cpu", noise=noise)
    ts = tr.init_state(0)
    jr.state_type, tr.fp = "FP", True
    jr.critic.fp_agents = tr.critic.fp_agents = jr.n_agents
    to_sd = (convert.squashed_policy_state_dict if algo == "hasac"
             else convert.deterministic_policy_state_dict)
    for st, jst in zip(ts.actors, js.actors):
        st.net.load_state_dict(to_sd(_np(jst.params)))
    ts.critic.nets.load_state_dict(convert.q_nets_state_dict(_np(js.critic.params)))
    return jr, js, tr, ts, noise, to_sd


@pytest.mark.parametrize("algo", ["hasac", "hatd3"])
def test_fp_actor_updates_match_jax(algo):
    """``_hasac_update`` and ``_ha_update`` on an FP sample: the joint action
    (HASAC: also the log-probability sum and the valid mask) tiled over the
    agent-major state rows; every actor after its step."""
    jr, js, tr, ts, noise, to_sd = _planar_runners(algo)
    n = jr.n_agents
    jsp, tsp = _fp_sample(5, jr.share_obs_dim, jr.obs_dims, [3, 3], n=n)
    k_actor, k_order = jax.random.split(jax.random.PRNGKey(7))
    if algo == "hasac":
        for i in range(n):
            noise.actions.append(normal(jax.random.fold_in(k_actor, 100 + i), (BATCH, 3)))
    order = np.asarray(jax.random.permutation(k_order, n))
    noise.perms.append(order)
    if algo == "hasac":
        for i in order:
            noise.actions.append(normal(jax.random.fold_in(k_actor, int(i)), (BATCH, 3)))
        jactors, _ = jr._hasac_update(js.actors, js.critic, jsp, k_actor, k_order)
        tr._hasac_update(ts, tsp)
    else:
        jactors = jr._ha_update(js.actors, js.critic, jsp, k_actor, k_order)
        tr._ha_update(ts, tsp)
    assert noise.drained()
    for st, jst in zip(ts.actors, jactors):
        ref = to_sd(_np(jst.params))
        for k, v in st.net.state_dict().items():
            _close(v, ref[k])


# --------------------------------------------------- replayed FP HASAC block
BLOCK_B, A = 4, 3       # envs; agents of SMACLite 3m


def _smac_configs():
    algo_args, env_args = jdefaults("hasac", "smaclite")
    algo_args["train"].update(n_rollout_threads=BLOCK_B, num_env_steps=10 ** 6,
                              warmup_steps=3 * BLOCK_B, train_interval=2, update_per_train=1)
    algo_args["algo"].update(batch_size=BATCH, buffer_size=200, n_step=3, auto_alpha=True)
    algo_args["model"].update(hidden_sizes=HIDDEN)
    # 4-step episodes: warmup and collect cross an episode end in every env
    env_args.update(map_name="3m", state_type="FP", episode_limit=4)
    return algo_args, env_args


def _queue_blocks(noise, jr, rng, n_actions):
    """The draws of 3 warmup steps, 2 collect steps and 2 updates."""
    rng, k = jax.random.split(rng)
    for kk in jax.random.split(k, 3):
        k1, k2 = jax.random.split(kk)
        for i in range(A):
            noise.ints.append((n_actions, randint(jax.random.fold_in(k1, i), (BLOCK_B, 1),
                                                  n_actions)))
        noise.resets.append(step_smaclite_reset_noise(k2, BLOCK_B, A, A))
    rng, k = jax.random.split(rng)
    for kk in jax.random.split(k, 2):
        k1, k2 = jax.random.split(kk)
        for i in range(A):
            noise.gumbels.append(gumbel_noise(jax.random.fold_in(k1, i),
                                              (BLOCK_B, n_actions)))
        noise.resets.append(step_smaclite_reset_noise(k2, BLOCK_B, A, A))
    cur = 5 * BLOCK_B
    for _ in range(2):
        rng, k_sample, k_next, k_actor, k_order = jax.random.split(rng, 5)
        noise.starts.append((cur, np.asarray(
            jax.random.randint(k_sample, (BATCH,), 0, jnp.int32(cur)))))
        for i in range(A):
            noise.gumbels.append(gumbel_noise(jax.random.fold_in(k_next, i),
                                              (BATCH, n_actions)))
        for i in range(A):
            noise.gumbels.append(gumbel_noise(jax.random.fold_in(k_actor, 100 + i),
                                              (BATCH, n_actions)))
        order = np.asarray(jax.random.permutation(k_order, A))
        noise.perms.append(order)
        for i in order:
            noise.gumbels.append(gumbel_noise(jax.random.fold_in(k_actor, int(i)),
                                              (BATCH, n_actions)))


def test_fp_hasac_block_on_smaclite_matches_jax():
    """Warmup (3 steps of random actions), collect (2 exploration steps) and
    train (2 updates) of discrete FP HASAC with auto-α: the FP buffer's rows,
    the carry, the metrics and every parameter after training."""
    algo_args, env_args = _smac_configs()
    args = {"algo": "hasac", "env": "smaclite", "exp_name": "parity"}
    jr = JRunner(args, copy.deepcopy(algo_args), copy.deepcopy(env_args))
    js = jr.init_state(0)
    noise = ReplayNoise()
    _, k_env, *_ = jax.random.split(jax.random.PRNGKey(0), A + 3)
    noise.resets.append(smaclite_reset_noise(jax.random.split(k_env, BLOCK_B), A, A))
    tr = OffPolicyRunner(args, algo_args, env_args, device="cpu", noise=noise)
    ts = tr.init_state(0)
    assert isinstance(ts.buffer, tbuf.ReplayBufferFP)
    for st, jst in zip(ts.actors, js.actors):
        st.net.load_state_dict(convert.policy_state_dict(_np(jst.params)))
        st.target.load_state_dict(convert.policy_state_dict(_np(jst.target_params)))
    ts.critic.nets.load_state_dict(convert.q_nets_state_dict(_np(js.critic.params)))
    ts.critic.targets.load_state_dict(convert.q_nets_state_dict(_np(js.critic.target_params)))
    n_actions = jr.act_spaces[0].n
    _queue_blocks(noise, jr, js.rng, n_actions)

    js = jr.warmup_block(js)
    js, jcm = jr.collect_block(js)
    js, jtm = jr.train_block(js)
    ts = tr.warmup_block(ts)
    ts, tcm = tr.collect_block(ts)
    rows = ts.buffer.cur_size
    assert rows == int(js.buffer.cur_size) == 5 * BLOCK_B
    jb = js.buffer
    for name in ("share_obs", "next_share_obs", "rewards", "dones", "terms"):
        assert getattr(ts.buffer, name).shape[1] == A
        _close(getattr(ts.buffer, name)[:rows], getattr(jb, name)[:rows], DATA_RTOL, DATA_ATOL)
    for name in ("obs", "next_obs", "valid_transitions"):
        for t, j in zip(getattr(ts.buffer, name), getattr(jb, name)):
            _close(t[:rows], j[:rows], DATA_RTOL, DATA_ATOL)
    for name in ("actions", "available_actions", "next_available_actions"):
        for t, j in zip(getattr(ts.buffer, name), getattr(jb, name)):
            _equal(t[:rows], j[:rows])
    # every env's 4-step episode ended inside the 5 steps: per-agent dones
    assert float(ts.buffer.dones[:rows].sum()) >= A * BLOCK_B
    for k in ("episode_return_sum", "episode_count", "mean_step_reward"):
        _close(tcm[k], jcm[k], DATA_RTOL, DATA_ATOL)
    _close(ts.carry.share_obs, js.carry.share_obs, DATA_RTOL, DATA_ATOL)

    ts, ttm = tr.train_block(ts)
    assert noise.drained()
    assert ts.total_it == int(js.total_it) == 2
    _close(ttm["critic_loss"], jtm["critic_loss"], DATA_RTOL, DATA_ATOL)
    for st, jst in zip(ts.actors, js.actors):
        for net, params in ((st.net, jst.params), (st.target, jst.target_params)):
            ref = convert.policy_state_dict(_np(params))
            for k, v in net.state_dict().items():
                _close(v, ref[k])
        _close(st.log_alpha.detach(), jst.log_alpha)
    for nets, params in ((ts.critic.nets, js.critic.params),
                         (ts.critic.targets, js.critic.target_params)):
        ref = convert.q_nets_state_dict(_np(params))
        for k, v in nets.state_dict().items():
            _close(v, ref[k])
    _close(ts.critic.log_alpha.detach(), js.critic.log_alpha)


def test_fp_had3qn_refuses():
    algo_args, env_args = jdefaults("had3qn", "smaclite")
    algo_args["train"].update(n_rollout_threads=2)
    with pytest.raises(ValueError, match="had3qn"):
        OffPolicyRunner({"algo": "had3qn", "env": "smaclite"}, algo_args,
                        dict(env_args, map_name="3m", state_type="FP"), device="cpu")
