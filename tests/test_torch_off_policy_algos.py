"""Port parity: the off-policy Q critics, the temperature updates, the polyak
update and the runner's actor updates (HASAC, HA and MA).

Both sides start from the same parameters (flax → ``convert``) and see the
same replay sample, built from a seed with numpy; the actor updates get the
JAX update's normals and agent permutation through a replaying noise source.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harl_tpu.algos import common as jcommon
from harl_tpu.algos import q_critics as jq
from harl_tpu.buffers.off_policy import Sample as JSample
from harl_tpu.runners.off_policy import OffPolicyRunner as JRunner
from harl_tpu.utils import spaces as jspaces
from harl_tpu.utils.config_tools import get_defaults_yaml_args as jdefaults
from harl_tpu_torch.algos import common as tcommon
from harl_tpu_torch.algos import q_critics as tq
from harl_tpu_torch.buffers.off_policy import Sample
from harl_tpu_torch.models.values import ContinuousQNet
from harl_tpu_torch.runners.off_policy import OffPolicyRunner
from harl_tpu_torch.utils import convert, spaces

from tests.torch_replay import ReplayNoise, normal, reset_noise

# Losses: float32 sums over 32 rows in another order. Parameters after two
# Adam steps with eps 1e-8: a step is about lr·sign(g) where |g| >> 1e-8, so
# a relative gradient error e moves a parameter by ~lr·e.
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
BATCH, DS, ACT_DIMS, OBS_DIMS, HIDDEN = 32, 11, (3, 3), (8, 8), [16, 16]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(a, b, rtol=PARAM_RTOL, atol=PARAM_ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.1 * rng.normal(size=x.shape)).astype(np.float32), params)


def _sample(seed, ds=DS, obs_dims=OBS_DIMS, act_dims=ACT_DIMS):
    """(JAX Sample, port Sample) of the same random rows: n-step rewards,
    per-sample γⁿ, some ends, some truncations, some invalid rows."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    dones = (rng.random((BATCH, 1)) < 0.3).astype(np.float32)
    d = dict(share_obs=f(BATCH, ds), next_share_obs=f(BATCH, ds), rewards=f(BATCH, 1),
             dones=dones, terms=dones * (rng.random((BATCH, 1)) < 0.5).astype(np.float32),
             gamma=(0.99 ** rng.integers(1, 4, (BATCH, 1))).astype(np.float32),
             obs=[f(BATCH, k) for k in obs_dims], next_obs=[f(BATCH, k) for k in obs_dims],
             actions=[np.tanh(f(BATCH, k)) for k in act_dims],
             valid_transitions=[(rng.random((BATCH, 1)) < 0.8).astype(np.float32)
                                for _ in obs_dims])
    js = JSample(available_actions=None, next_available_actions=None,
                 **{k: tuple(map(jnp.asarray, v)) if isinstance(v, list) else jnp.asarray(v)
                    for k, v in d.items()})
    ts = Sample(**{k: [torch.from_numpy(x) for x in v] if isinstance(v, list)
                   else torch.from_numpy(v) for k, v in d.items()})
    return js, ts


CRITIC_CFG = dict(critic_lr=5e-4, polyak=0.005, hidden_sizes=HIDDEN, huber_delta=10.0,
                  alpha_lr=3e-4)


def _critics(name, cfg):
    jspace = [jspaces.Box.create(-1.0, 1.0, d) for d in ACT_DIMS]
    tspace = [spaces.Box.create(-1.0, 1.0, d) for d in ACT_DIMS]
    jc = getattr(jq, name)(DS, jspace, cfg)
    tc = getattr(tq, name)(DS, tspace, cfg, device="cpu")
    js = jc.init(jax.random.PRNGKey(0))
    # targets away from the nets, so the target network is what is read
    js = js._replace(target_params=_perturbed(js.target_params, 1))
    ts = tc.init()
    ts.nets.load_state_dict(convert.q_nets_state_dict(_np(js.params)))
    ts.targets.load_state_dict(convert.q_nets_state_dict(_np(js.target_params)))
    return jc, js, tc, ts


@pytest.mark.parametrize("name,cfg", [
    ("ContinuousQCritic", dict(use_huber_loss=False)),
    ("ContinuousQCritic", dict(use_huber_loss=False, use_proper_time_limits=False)),
    ("TwinContinuousQCritic", dict(use_huber_loss=False)),
    ("SoftTwinContinuousQCritic", dict(use_valuenorm=True)),
    ("SoftTwinContinuousQCritic", dict(use_valuenorm=False, use_huber_loss=False)),
], ids=["single", "single-dones", "twin", "soft-valuenorm-huber", "soft-mse"])
def test_critic_train_matches_jax(name, cfg):
    jc, js, tc, ts = _critics(name, {**CRITIC_CFG, **cfg})
    for step in range(2):
        jsp, tsp = _sample(10 + step)
        rng = np.random.default_rng(20 + step)
        next_joint = np.tanh(rng.standard_normal((BATCH, sum(ACT_DIMS)))).astype(np.float32)
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
    for nets, params in ((ts.nets, js.params), (ts.targets, js.target_params)):
        ref = convert.q_nets_state_dict(_np(params))
        for k, v in nets.state_dict().items():
            _close(v, ref[k])
    assert (ts.value_norm is None) == (js.value_norm is None)
    if ts.value_norm is not None:
        for k in ("running_mean", "running_mean_sq", "debiasing_term"):
            _close(getattr(ts.value_norm, k), getattr(js.value_norm, k), 1e-6, 1e-7)
    # the targets move only by soft updates
    tc.soft_update_targets(ts)
    js = jc.soft_update_targets(js)
    for k, v in ts.targets.state_dict().items():
        _close(v, convert.q_nets_state_dict(_np(js.target_params))[k])


@pytest.mark.parametrize("start,logp_mean,target_entropy", [(0.0, -3.0, -6.0),
                                                           (2.0, 3.0, 1.0)],
                         ids=["free", "clamped"])
def test_update_alpha_matches_jax(start, logp_mean, target_entropy):
    """Two critic-side temperature steps; from log α = 2 with a gradient
    that pushes it up, the clamp at 2 holds."""
    jc, js, tc, ts = _critics("SoftTwinContinuousQCritic",
                              {**CRITIC_CFG, "auto_alpha": True})
    js = js._replace(log_alpha=jnp.asarray(start))
    with torch.no_grad():
        ts.log_alpha.fill_(start)
    rng = np.random.default_rng(3)
    for _ in range(2):
        logp = (logp_mean + rng.standard_normal((BATCH, 1))).astype(np.float32)
        js = jc.update_alpha(js, jnp.asarray(logp), target_entropy)
        tc.update_alpha(ts, torch.from_numpy(logp), target_entropy)
    la = ts.log_alpha.detach()
    _close(la, js.log_alpha, 1e-6, 1e-7)
    assert float(la) == 2.0 if start == 2.0 else float(la) < 0.0


def test_soft_update_matches_jax():
    """θ′ ← (1−τ)θ′ + τθ written out as the JAX package writes it: equal to
    float32 rounding (the JAX side may fuse a product into the sum)."""
    nets = [ContinuousQNet(DS, 6, HIDDEN, device="cpu",
                           generator=torch.Generator().manual_seed(k)) for k in range(2)]
    sd = lambda net: {k: v.numpy().copy() for k, v in net.state_dict().items()}
    target, source = sd(nets[0]), sd(nets[1])
    tcommon.soft_update(nets[0], nets[1], 0.005)
    ref = jcommon.soft_update(target, source, 0.005)
    for k, v in nets[0].state_dict().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(ref[k]), rtol=1e-7, atol=1e-9)


# ------------------------------------------------------------ actor updates
UPDATE_CASES = [("hasac", {}), ("hasac", {"auto_alpha": True}),
                ("hasac", {"use_policy_active_masks": False, "fixed_order": True}),
                ("hatd3", {}), ("haddpg", {"fixed_order": True}), ("maddpg", {}),
                ("matd3", {})]


def _runners(algo, updates):
    algo_args, env_args = jdefaults(algo, "mamujoco_jax")
    algo_args["train"].update(n_rollout_threads=2)
    algo_args["algo"].update(batch_size=BATCH, buffer_size=100, **updates)
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
    to_sd = (convert.squashed_policy_state_dict if algo == "hasac"
             else convert.deterministic_policy_state_dict)
    for st, jst in zip(ts.actors, js.actors):
        st.net.load_state_dict(to_sd(_np(jst.params)))
        st.target.load_state_dict(to_sd(_np(jst.target_params)))
    ts.critic.nets.load_state_dict(convert.q_nets_state_dict(_np(js.critic.params)))
    return jr, js, tr, ts, noise, to_sd


@pytest.mark.parametrize("algo,updates", UPDATE_CASES,
                         ids=[a + "".join(f"-{k}" for k in u) for a, u in UPDATE_CASES])
def test_actor_updates_match_jax(algo, updates):
    """``_hasac_update``, ``_ha_update`` and ``_ma_update`` from the same
    state, sample and draws: every actor after its step, and the
    temperatures under auto-α."""
    jr, js, tr, ts, noise, to_sd = _runners(algo, updates)
    before = [copy.deepcopy(st.net.state_dict()) for st in ts.actors]
    obs_dims = jr.obs_dims
    jsp, tsp = _sample(5, jr.share_obs_dim, obs_dims, [3, 3])
    k_actor, k_order = jax.random.split(jax.random.PRNGKey(7))
    N = jr.n_agents
    if algo == "hasac":
        for i in range(N):
            noise.actions.append(normal(jax.random.fold_in(k_actor, 100 + i), (BATCH, 3)))
    order = range(N)
    if algo not in ("maddpg", "matd3") and not updates.get("fixed_order"):
        order = np.asarray(jax.random.permutation(k_order, N))
        noise.perms.append(order)
    if algo == "hasac":
        for i in order:
            noise.actions.append(normal(jax.random.fold_in(k_actor, int(i)), (BATCH, 3)))

    if algo == "hasac":
        jactors, jcritic = jr._hasac_update(js.actors, js.critic, jsp, k_actor, k_order)
        tr._hasac_update(ts, tsp)
    elif algo in ("maddpg", "matd3"):
        jactors, jcritic = jr._ma_update(js.actors, js.critic, jsp, k_actor), js.critic
        tr._ma_update(ts, tsp)
    else:
        jactors = jr._ha_update(js.actors, js.critic, jsp, k_actor, k_order)
        jcritic = js.critic
        tr._ha_update(ts, tsp)
    assert noise.drained()
    for st, jst in zip(ts.actors, jactors):
        ref = to_sd(_np(jst.params))
        for k, v in st.net.state_dict().items():
            _close(v, ref[k])
        if updates.get("auto_alpha"):
            _close(st.log_alpha.detach(), jst.log_alpha, 1e-6, 1e-7)
    if updates.get("auto_alpha"):
        _close(ts.critic.log_alpha.detach(), jcritic.log_alpha, 1e-6, 1e-7)
    # the update stepped every actor and left the critic alone
    for st, sd in zip(ts.actors, before):
        assert all(not torch.equal(v, sd[k]) for k, v in st.net.state_dict().items()
                   if k.endswith("weight"))
    ref = convert.q_nets_state_dict(_np(js.critic.params))
    for k, v in ts.critic.nets.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k].numpy())
    assert all(p.grad is None for p in ts.critic.nets.parameters())
