"""Port parity: discrete HASAC and HAD3QN against the JAX package.

The straight-through Gumbel-softmax, ``StochasticMlpPolicy`` and
``DuelingQNet`` (from converted flax parameters), ``DiscreteQCritic``'s
codecs and TD step, the discrete ``HASACActor`` with availability masks,
the runner's ``_had3qn_update`` and discrete ``_hasac_update``, and whole
replayed warmup+collect+train blocks of HAD3QN on simple_spread and of
discrete HASAC on speaker-listener (Discrete(3) and Discrete(5) agents).
Every draw comes from the JAX keys through a replaying noise source
(``tests/torch_replay.py``): the Gumbels of ``gumbel_softmax``
(``off_policy_actors.py:148``), HAD3QN's ε-greedy ``randint``/``uniform``
pair (``:227-235``) and the discrete warmup's ``randint`` (``:182-197``).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harl_tpu.algos import off_policy_actors as jactors
from harl_tpu.algos import q_critics as jq
from harl_tpu.buffers.off_policy import Sample as JSample
from harl_tpu.models.policies import StochasticMlpPolicy as JStochasticMlp
from harl_tpu.models.values import DuelingQNet as JDueling
from harl_tpu.ops import distributions as jD
from harl_tpu.runners.off_policy import OffPolicyRunner as JRunner
from harl_tpu.utils import spaces as jspaces
from harl_tpu.utils.config_tools import get_defaults_yaml_args as jdefaults
from harl_tpu_torch.algos import off_policy_actors as tactors
from harl_tpu_torch.algos import q_critics as tq
from harl_tpu_torch.buffers.off_policy import Sample
from harl_tpu_torch.models.policies import StochasticMlpPolicy
from harl_tpu_torch.models.values import DuelingQNet
from harl_tpu_torch.ops import distributions as tD
from harl_tpu_torch.runners.off_policy import OffPolicyRunner
from harl_tpu_torch.utils import convert, spaces

from tests.torch_replay import (ReplayNoise, gumbel_noise, mpe_reset_noise, randint,
                                step_mpe_reset_noise, uniform)

# networks and single steps: float32 matmuls in another order
NET_RTOL, NET_ATOL = 1e-5, 1e-5
# parameters after Adam steps with eps 1e-8 (test_torch_off_policy_algos.py)
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
# buffer rows of replayed blocks: the env's floats (test_torch_runner_off_policy.py)
DATA_RTOL, DATA_ATOL = 1e-4, 2e-4
BATCH, HIDDEN = 32, [16, 16]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(a, b, rtol=PARAM_RTOL, atol=PARAM_ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _t(x):
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------- ST-Gumbel
def test_gumbel_softmax_and_onehot_match_jax():
    """The hard sample, its straight-through gradient (softmax's), and the
    argmax one-hot, from the same Gumbel draw."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(64, 7)).astype(np.float32) * 3
    w = rng.normal(size=(64, 7)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    g = gumbel_noise(key, logits.shape)

    def jf(lg):
        return jnp.sum(jD.gumbel_softmax(key, lg, hard=True) * w)

    jy = jD.gumbel_softmax(key, jnp.asarray(logits), hard=True)
    jgrad = jax.grad(jf)(jnp.asarray(logits))
    tl = _t(logits).requires_grad_(True)
    ty = tD.gumbel_softmax(tl, _t(g), hard=True)
    (ty * _t(w)).sum().backward()
    np.testing.assert_array_equal(ty.detach().numpy().argmax(-1), np.asarray(jy).argmax(-1))
    _close(ty.detach(), jy, 1e-6, 1e-6)
    assert set(np.round(ty.detach().numpy(), 5).ravel()) <= {0.0, 1.0}
    _close(tl.grad, jgrad, NET_RTOL, 1e-6)
    assert float(tl.grad.abs().sum()) > 0      # the gradient flows through softmax
    soft = tD.gumbel_softmax(_t(logits), _t(g), hard=False)
    _close(soft, jD.gumbel_softmax(key, jnp.asarray(logits), hard=False), 1e-6, 1e-6)
    np.testing.assert_array_equal(tD.onehot_from_logits(_t(logits)).numpy(),
                                  np.asarray(jD.onehot_from_logits(jnp.asarray(logits))))


# ---------------------------------------------------------------- networks
def test_stochastic_mlp_policy_matches_flax():
    space_t, space_j = spaces.Discrete(5), jspaces.Discrete(5)
    jpol = JStochasticMlp(action_space=space_j, hidden_sizes=HIDDEN)
    obs = np.random.default_rng(2).normal(size=(32, 11)).astype(np.float32)
    params = jpol.init(jax.random.PRNGKey(3), jnp.asarray(obs))
    # perturb the head so the logits are not ~0 (gain 0.01)
    params = jax.tree.map(lambda x: x * 3.0, params)
    tpol = StochasticMlpPolicy(11, space_t, HIDDEN, device="cpu")
    tpol.load_state_dict(convert.policy_state_dict(_np(params)))
    (tl,) = tpol(_t(obs))
    (jl,) = jpol.apply(params, jnp.asarray(obs))
    _close(tl.detach(), jl, NET_RTOL, NET_ATOL)


@pytest.mark.parametrize("out", [5, 125])
def test_dueling_q_net_matches_flax(out):
    jnet = JDueling(output_dim=out, base_hidden_sizes=(16, 16), dueling_v_hidden_sizes=(8,),
                    dueling_a_hidden_sizes=(8,))
    obs = np.random.default_rng(4).normal(size=(32, 18)).astype(np.float32)
    params = jnet.init(jax.random.PRNGKey(5), jnp.asarray(obs))
    tnet = DuelingQNet(18, out, (16, 16), dueling_v_hidden_sizes=(8,),
                       dueling_a_hidden_sizes=(8,), device="cpu")
    tnet.load_state_dict(convert.dueling_q_state_dict(_np(params)))
    _close(tnet(_t(obs)).detach(), jnet.apply(params, jnp.asarray(obs)), NET_RTOL, NET_ATOL)


# ------------------------------------------------------- DiscreteQCritic
CRITIC_CFG = dict(critic_lr=1e-3, polyak=0.005, hidden_sizes=HIDDEN, base_hidden_sizes=[16, 16],
                  dueling_v_hidden_sizes=[8], dueling_a_hidden_sizes=[8])


def _discrete_critics(ns, ds=12):
    jc = jq.DiscreteQCritic(ds, [jspaces.Discrete(n) for n in ns], CRITIC_CFG)
    tc = tq.DiscreteQCritic(ds, [spaces.Discrete(n) for n in ns], CRITIC_CFG, device="cpu")
    return jc, tc


def _discrete_sample(seed, ds, obs_dims, ns, avail=True):
    """(JAX Sample, port Sample) of the same rows: index actions (as the
    buffer keeps them, float), availability with at least one action on."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    dones = (rng.random((BATCH, 1)) < 0.3).astype(np.float32)

    def av(n):
        a = (rng.random((BATCH, n)) < 0.7).astype(np.float32)
        a[np.arange(BATCH), rng.integers(0, n, BATCH)] = 1.0
        return a

    d = dict(share_obs=f(BATCH, ds), next_share_obs=f(BATCH, ds), rewards=f(BATCH, 1),
             dones=dones, terms=dones * (rng.random((BATCH, 1)) < 0.5).astype(np.float32),
             gamma=(0.99 ** rng.integers(1, 4, (BATCH, 1))).astype(np.float32),
             obs=[f(BATCH, k) for k in obs_dims], next_obs=[f(BATCH, k) for k in obs_dims],
             actions=[rng.integers(0, n, (BATCH, 1)).astype(np.float32) for n in ns],
             valid_transitions=[(rng.random((BATCH, 1)) < 0.8).astype(np.float32)
                                for _ in obs_dims],
             available_actions=[av(n) for n in ns] if avail else None,
             next_available_actions=[av(n) for n in ns] if avail else None)
    js = JSample(**{k: None if v is None else tuple(map(jnp.asarray, v)) if isinstance(v, list)
                    else jnp.asarray(v) for k, v in d.items()})
    ts = Sample(**{k: None if v is None else [_t(x) for x in v] if isinstance(v, list)
                   else _t(v) for k, v in d.items()})
    return js, ts


@pytest.mark.parametrize("ns", [(5, 5, 5), (3, 5), (4, 2, 3)])
def test_discrete_q_critic_codecs_match_jax(ns):
    jc, tc = _discrete_critics(ns)
    rng = np.random.default_rng(6)
    acts = [rng.integers(0, n, (50, 1)).astype(np.int32) for n in ns]
    assert tc.joint_action_dim == jc.joint_action_dim == int(np.prod(ns))
    joint = tc.indiv_to_joint([_t(a) for a in acts])
    np.testing.assert_array_equal(joint.numpy(), np.asarray(jc.indiv_to_joint(tuple(acts))))
    for t, a in zip(tc.joint_to_indiv(joint), acts):
        np.testing.assert_array_equal(t.numpy(), a)
    every = np.arange(jc.joint_action_dim)[:, None]
    np.testing.assert_array_equal(
        np.concatenate([x.numpy() for x in tc.joint_to_indiv(_t(every))], -1),
        np.concatenate([np.asarray(x) for x in jc.joint_to_indiv(jnp.asarray(every))], -1))
    for i in range(len(ns)):
        np.testing.assert_array_equal(tc.get_joint_idx([_t(a) for a in acts], i).numpy(),
                                      np.asarray(jc.get_joint_idx(tuple(acts), i)))


@pytest.mark.parametrize("use_proper_time_limits", [True, False])
def test_discrete_q_critic_train_matches_jax(use_proper_time_limits):
    ns = (5, 5, 5)
    cfg = dict(CRITIC_CFG, use_proper_time_limits=use_proper_time_limits)
    jc = jq.DiscreteQCritic(12, [jspaces.Discrete(n) for n in ns], cfg)
    tc = tq.DiscreteQCritic(12, [spaces.Discrete(n) for n in ns], cfg, device="cpu")
    js = jc.init(jax.random.PRNGKey(7))
    ts = tc.init()
    ts.nets.load_state_dict(convert.q_nets_state_dict(_np(js.params), convert.dueling_q_state_dict))
    ts.targets.load_state_dict(convert.q_nets_state_dict(_np(js.params),
                                                         convert.dueling_q_state_dict))
    rng = np.random.default_rng(8)
    for step in range(2):
        jsp, tsp = _discrete_sample(10 + step, 12, (4, 4, 4), ns, avail=False)
        nxt = [rng.integers(0, n, (BATCH, 1)).astype(np.int32) for n in ns]
        js, jloss = jc.train(js, jsp, tuple(map(jnp.asarray, nxt)))
        tloss = tc.train(ts, tsp, [_t(a) for a in nxt])
        _close(tloss, jloss, NET_RTOL, NET_ATOL)
    ref = convert.q_nets_state_dict(_np(js.params), convert.dueling_q_state_dict)
    for k, v in ts.nets.state_dict().items():
        _close(v, ref[k])
    share = tsp.share_obs
    _close(tc.get_values(ts, share, [_t(a) for a in nxt]).detach(),
           jc.get_values(js, jsp.share_obs, tuple(map(jnp.asarray, nxt))), NET_RTOL, NET_ATOL)


# ------------------------------------------------------ discrete HASAC actor
def test_discrete_hasac_actor_matches_jax():
    """Masked logits → straight-through one-hot, Σ onehot·logits, the
    argmax index for the env and the argmax of the masked logits for eval."""
    cfg = dict(lr=5e-4, polyak=0.005, hidden_sizes=HIDDEN)
    ja = jactors.HASACActor(9, jspaces.Discrete(6), cfg)
    ta = tactors.HASACActor(9, spaces.Discrete(6), cfg, device="cpu")
    assert (ta.kind, ta.act_dim) == ("Discrete", 1)
    jst = ja.init(jax.random.PRNGKey(9))
    params = jax.tree.map(lambda x: x * 4.0, jst.params)   # logits of order 1
    tst = ta.init()
    tst.net.load_state_dict(convert.policy_state_dict(_np(params)))
    jsp, tsp = _discrete_sample(11, 4, (9,), (6,))
    obs, avail = tsp.obs[0], tsp.available_actions[0]
    key = jax.random.PRNGKey(12)
    g = _t(gumbel_noise(key, (BATCH, 6)))
    ja_oh, ja_lp = ja.get_actions_with_logprobs(params, jsp.obs[0], key, jsp.available_actions[0])
    ta_oh, ta_lp = ta.get_actions_with_logprobs(tst.net, obs, g, avail)
    np.testing.assert_array_equal(ta_oh.detach().numpy().argmax(-1), np.asarray(ja_oh).argmax(-1))
    _close(ta_oh.detach(), ja_oh, 1e-6, 1e-6)
    _close(ta_lp.detach(), ja_lp, NET_RTOL, NET_ATOL)
    # masked actions are never taken
    taken = ta_oh.detach().numpy().argmax(-1)
    assert (avail.numpy()[np.arange(BATCH), taken] == 1).all()
    np.testing.assert_array_equal(
        ta.get_actions(tst.net, obs, g, avail).numpy(),
        np.asarray(ja.get_actions(params, jsp.obs[0], key, jsp.available_actions[0])))
    np.testing.assert_array_equal(
        ta.deterministic_actions(tst.net, obs, avail).numpy(),
        np.asarray(ja.get_actions(params, jsp.obs[0], key, jsp.available_actions[0],
                                  stochastic=False)))
    # MultiDiscrete, refused before, builds (tests/test_torch_multidiscrete_cnn.py)
    md = tactors.HASACActor(9, spaces.MultiDiscrete((2, 3)), cfg)
    assert (md.kind, md.act_dim) == ("MultiDiscrete", 2)


# ---------------------------------------------------------- runner updates
def _mpe_configs(algo, scenario, B=2, **algo_updates):
    algo_args, env_args = jdefaults(algo, "pettingzoo_mpe")
    algo_args["train"].update(n_rollout_threads=B, num_env_steps=10 ** 6)
    algo_args["algo"].update(batch_size=BATCH, buffer_size=200, **algo_updates)
    algo_args["model"].update(hidden_sizes=HIDDEN)
    if algo == "had3qn":
        algo_args["algo"].update(base_hidden_sizes=[16, 16], dueling_v_hidden_sizes=[8],
                                 dueling_a_hidden_sizes=[8])
    env_args.update(scenario=scenario, continuous_actions=False)
    return algo_args, env_args


def _to_sd(algo):
    return convert.policy_state_dict if algo == "hasac" else convert.dueling_q_state_dict


def _critic_sd(algo, params):
    return (convert.q_nets_state_dict(params) if algo == "hasac"
            else convert.q_nets_state_dict(params, convert.dueling_q_state_dict))


def _runners(algo, scenario, algo_args, env_args):
    args = {"algo": algo, "env": "pettingzoo_mpe", "exp_name": "parity"}
    jr = JRunner(args, copy.deepcopy(algo_args), copy.deepcopy(env_args))
    js = jr.init_state(0)
    B, N = algo_args["train"]["n_rollout_threads"], jr.n_agents
    noise = ReplayNoise()
    _, k_env, *_ = jax.random.split(jax.random.PRNGKey(0), N + 3)
    noise.resets.append(mpe_reset_noise(jax.random.split(k_env, B), N,
                                        scenario != "simple_spread_v2"))
    tr = OffPolicyRunner(args, algo_args, env_args, device="cpu", noise=noise)
    ts = tr.init_state(0)
    to_sd = _to_sd(algo)
    for st, jst in zip(ts.actors, js.actors):
        st.net.load_state_dict(to_sd(_np(jst.params)))
        st.target.load_state_dict(to_sd(_np(jst.target_params)))
    ts.critic.nets.load_state_dict(_critic_sd(algo, _np(js.critic.params)))
    ts.critic.targets.load_state_dict(_critic_sd(algo, _np(js.critic.target_params)))
    return jr, js, tr, ts, noise


UPDATE_CASES = [("had3qn", "simple_spread_v2", {}),
                ("had3qn", "simple_speaker_listener_v3", {"fixed_order": True}),
                ("hasac", "simple_speaker_listener_v3", {"auto_alpha": True}),
                ("hasac", "simple_spread_v2", {"use_policy_active_masks": False})]


@pytest.mark.parametrize("algo,scenario,updates", UPDATE_CASES,
                         ids=[f"{a}-{s.split('_v')[0]}" + "".join(f"-{k}" for k in u)
                              for a, s, u in UPDATE_CASES])
def test_discrete_actor_updates_match_jax(algo, scenario, updates):
    """``_had3qn_update`` and discrete ``_hasac_update`` from the same state,
    sample and draws: every actor after its step (and the temperatures)."""
    jr, js, tr, ts, noise = _runners(algo, scenario, *_mpe_configs(algo, scenario, **updates))
    ns = [sp.n for sp in jr.act_spaces]
    jsp, tsp = _discrete_sample(13, jr.share_obs_dim, jr.obs_dims, ns)
    k_actor, k_order = jax.random.split(jax.random.PRNGKey(14))
    N = jr.n_agents
    if algo == "hasac":
        for i in range(N):
            noise.gumbels.append(gumbel_noise(jax.random.fold_in(k_actor, 100 + i),
                                              (BATCH, ns[i])))
    order = range(N)
    if not updates.get("fixed_order"):
        order = np.asarray(jax.random.permutation(k_order, N))
        noise.perms.append(order)
    if algo == "hasac":
        for i in order:
            noise.gumbels.append(gumbel_noise(jax.random.fold_in(k_actor, int(i)),
                                              (BATCH, ns[i])))
        jactors_, jcritic = jr._hasac_update(js.actors, js.critic, jsp, k_actor, k_order)
        tr._hasac_update(ts, tsp)
    else:
        jactors_, jcritic = jr._had3qn_update(js.actors, js.critic, jsp, k_order), js.critic
        tr._had3qn_update(ts, tsp)
    assert noise.drained()
    to_sd = _to_sd(algo)
    for st, jst in zip(ts.actors, jactors_):
        ref = to_sd(_np(jst.params))
        for k, v in st.net.state_dict().items():
            _close(v, ref[k])
        if updates.get("auto_alpha"):
            _close(st.log_alpha.detach(), jst.log_alpha, 1e-6, 1e-7)
    if updates.get("auto_alpha"):
        _close(ts.critic.log_alpha.detach(), jcritic.log_alpha, 1e-6, 1e-7)
    assert all(p.grad is None for p in ts.critic.nets.parameters())


# ---------------------------------------------------------- replayed blocks
B = 4


def _queue_warmup(noise, rng, steps, ns, goals):
    rng, k = jax.random.split(rng)
    for kk in jax.random.split(k, steps):
        k1, k2 = jax.random.split(kk)
        for i, n in enumerate(ns):
            noise.ints.append((n, randint(jax.random.fold_in(k1, i), (B, 1), n)))
        noise.resets.append(step_mpe_reset_noise(k2, B, len(ns), goals))
    return rng


def _queue_collect(noise, rng, steps, ns, goals, algo):
    rng, k = jax.random.split(rng)
    for kk in jax.random.split(k, steps):
        k1, k2 = jax.random.split(kk)
        for i, n in enumerate(ns):
            ki = jax.random.fold_in(k1, i)
            if algo == "hasac":
                noise.gumbels.append(gumbel_noise(ki, (B, n)))
            else:   # ε-greedy: randint from the first half, the coin from the second
                ka, kb = jax.random.split(ki)
                noise.ints.append((n, randint(ka, (B, 1), n)))
                noise.uniforms.append(uniform(kb, (B, 1)))
        noise.resets.append(step_mpe_reset_noise(k2, B, len(ns), goals))
    return rng


def _queue_train(noise, jr, rng, n_updates, cur_size):
    ns, N = [sp.n for sp in jr.act_spaces], jr.n_agents
    for _ in range(n_updates):
        rng, k_sample, k_next, k_actor, k_order = jax.random.split(rng, 5)
        noise.starts.append((cur_size, np.asarray(
            jax.random.randint(k_sample, (BATCH,), 0, jnp.int32(cur_size)))))
        if jr.algo == "hasac":
            for i, n in enumerate(ns):
                noise.gumbels.append(gumbel_noise(jax.random.fold_in(k_next, i), (BATCH, n)))
            for i, n in enumerate(ns):
                noise.gumbels.append(gumbel_noise(jax.random.fold_in(k_actor, 100 + i),
                                                  (BATCH, n)))
        order = np.asarray(jax.random.permutation(k_order, N))
        noise.perms.append(order)
        if jr.algo == "hasac":
            for i in order:
                noise.gumbels.append(gumbel_noise(jax.random.fold_in(k_actor, int(i)),
                                                  (BATCH, ns[i])))


BLOCK_CASES = [("had3qn", "simple_spread_v2", {}),
               ("hasac", "simple_speaker_listener_v3", {"auto_alpha": True, "n_step": 3})]


@pytest.mark.parametrize("algo,scenario,updates", BLOCK_CASES,
                         ids=[f"{a}-{s.split('_v')[0]}" for a, s, _ in BLOCK_CASES])
def test_blocks_match_jax(algo, scenario, updates):
    """Warmup (2 steps of random indices), collect (2 exploration steps) and
    train (2 updates), with episodes of 3 steps: the buffer's rows, the
    availability rows, the metrics and every parameter after training."""
    algo_args, env_args = _mpe_configs(algo, scenario, B=B, **updates)
    algo_args["train"].update(warmup_steps=2 * B, train_interval=2, update_per_train=1)
    env_args.update(max_cycles=3)
    jr, js, tr, ts, noise = _runners(algo, scenario, algo_args, env_args)
    ns, goals = [sp.n for sp in jr.act_spaces], scenario != "simple_spread_v2"
    rng = _queue_warmup(noise, js.rng, 2, ns, goals)
    rng = _queue_collect(noise, rng, 2, ns, goals, algo)
    _queue_train(noise, jr, rng, 2, cur_size=4 * B)

    js = jr.warmup_block(js)
    js, jcm = jr.collect_block(js)
    js, jtm = jr.train_block(js)
    ts = tr.warmup_block(ts)
    ts, tcm = tr.collect_block(ts)
    rows = ts.buffer.cur_size
    assert rows == int(js.buffer.cur_size) == 4 * B
    jb = js.buffer
    for name in ("share_obs", "next_share_obs", "rewards", "dones", "terms"):
        _close(getattr(ts.buffer, name)[:rows], getattr(jb, name)[:rows], DATA_RTOL, DATA_ATOL)
    for name in ("obs", "next_obs", "valid_transitions"):
        for t, j in zip(getattr(ts.buffer, name), getattr(jb, name)):
            _close(t[:rows], j[:rows], DATA_RTOL, DATA_ATOL)
    for name in ("actions", "available_actions", "next_available_actions"):
        for t, j in zip(getattr(ts.buffer, name), getattr(jb, name)):
            np.testing.assert_array_equal(t[:rows].numpy(), np.asarray(j[:rows]))
    # every env truncated once (max_cycles 3): dones without terms
    assert float(ts.buffer.dones.sum()) == B and float(ts.buffer.terms.sum()) == 0
    for k in ("episode_return_sum", "episode_count", "mean_step_reward"):
        _close(tcm[k], jcm[k], DATA_RTOL, DATA_ATOL)
    np.testing.assert_array_equal(ts.carry.avail.numpy(), np.asarray(js.carry.avail))

    ts, ttm = tr.train_block(ts)
    assert noise.drained()
    assert ts.total_it == int(js.total_it) == 2
    _close(ttm["critic_loss"], jtm["critic_loss"], DATA_RTOL, DATA_ATOL)
    to_sd = _to_sd(algo)
    for st, jst in zip(ts.actors, js.actors):
        for net, params in ((st.net, jst.params), (st.target, jst.target_params)):
            ref = to_sd(_np(params))
            for k, v in net.state_dict().items():
                _close(v, ref[k])
        if updates.get("auto_alpha"):
            _close(st.log_alpha.detach(), jst.log_alpha)
    for nets, params in ((ts.critic.nets, js.critic.params),
                         (ts.critic.targets, js.critic.target_params)):
        ref = _critic_sd(algo, _np(params))
        for k, v in nets.state_dict().items():
            _close(v, ref[k])
    if updates.get("auto_alpha"):
        _close(ts.critic.log_alpha.detach(), js.critic.log_alpha)
    assert tr.target_entropy == pytest.approx(jr.target_entropy)
