"""Port parity: the HAPPO actor update, the V critic update and the
optimizer's gradient clip.

Both sides start from the same parameters (flax → ``convert``), see the
same batch and, with several minibatches, the same per-epoch permutations
(the JAX update draws them from its key; the test re-derives them and hands
them to the port).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from harl_tpu.algos import common as jcommon
from harl_tpu.algos.critics import CriticBatch as JCriticBatch
from harl_tpu.algos.critics import VCritic as JVCritic
from harl_tpu.algos.happo import ActorBatch as JActorBatch
from harl_tpu.algos.happo import HAPPOActor as JActor
from harl_tpu.models.policies import StochasticPolicy as JPolicy
from harl_tpu.models.values import VNet as JVNet
from harl_tpu.ops import value_norm as jvn
from harl_tpu.utils import spaces as jspaces
from harl_tpu_torch.algos import common as tcommon
from harl_tpu_torch.algos.critics import CriticBatch, VCritic
from harl_tpu_torch.algos.happo import ActorBatch, HAPPOActor
from harl_tpu_torch.models.policies import StochasticPolicy
from harl_tpu_torch.models.values import VNet
from harl_tpu_torch.ops import value_norm as tvn
from harl_tpu_torch.utils import convert, spaces

# Losses and grad norms: float32 sums over 24 rows in another order.
# Parameters after 4 Adam steps: Adam divides by sqrt(v)+eps, so a relative
# gradient error e moves a parameter by about lr·e per step.
STAT_RTOL, STAT_ATOL = 2e-5, 2e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 2e-5
T, B, OBS_DIM, ACT_DIM, DS = 4, 6, 10, 2, 9
HIDDEN = (16, 16)
CFG = dict(ppo_epoch=2, critic_epoch=2, clip_param=0.2, entropy_coef=0.01,
           value_loss_coef=1.0, use_clipped_value_loss=True, use_huber_loss=True,
           huber_delta=10.0, use_policy_active_masks=True, action_aggregation="prod",
           std_x_coef=1.0, std_y_coef=0.5)
LR, EPS, MAX_NORM = 5e-4, 1e-5, 10.0


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _same_params(tnet, flax_params, to_state_dict):
    ref = to_state_dict(_np_tree(flax_params))
    got = tnet.state_dict()
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k], PARAM_RTOL, PARAM_ATOL)


def _jax_perms(key, epochs, M):
    return np.array(jax.vmap(lambda k: jax.random.permutation(k, M))(
        jax.random.split(key, epochs)))


def _actor_case(num_mini_batch, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    space = jspaces.Box.create(-1.0, 1.0, ACT_DIM)
    jpol = JPolicy(action_space=space, hidden_sizes=HIDDEN)
    obs = rng.normal(size=(T, B, OBS_DIM)).astype(f)
    params = jpol.init(jax.random.PRNGKey(seed), jnp.asarray(obs[0]))
    params = jax.tree.map(lambda x: x + 0.2 * rng.normal(size=x.shape).astype(f), params)
    actions = rng.uniform(-1, 1, size=(T, B, ACT_DIM)).astype(f)
    (mean, log_std), _ = jpol.apply(params, jnp.asarray(obs))
    std = jax.nn.sigmoid(log_std) * 0.5
    logp = np.asarray(-((actions - mean) ** 2) / (2 * std ** 2) - jnp.log(std)
                      - 0.5 * np.log(2 * np.pi))
    # behaviour log-probs off the current policy, so some ratios clip
    logp = (logp + 0.3 * rng.normal(size=logp.shape)).astype(f)
    active = (rng.uniform(size=(T, B, 1)) > 0.2).astype(f)
    adv = rng.normal(0.5, 2.0, size=(T, B, 1)).astype(f)
    factor = rng.uniform(0.5, 1.5, size=(T, B, 1)).astype(f)
    cfg = dict(CFG, actor_num_mini_batch=num_mini_batch)
    tx = jcommon.make_optimizer(LR, EPS, 0.0, MAX_NORM)
    jactor = JActor(jpol, space, tx, cfg)
    jbatch = JActorBatch(obs=jnp.asarray(obs), rnn_states=jnp.zeros((T, B, 1, 16)),
                         actions=jnp.asarray(actions), logp=jnp.asarray(logp),
                         masks=jnp.ones((T, B, 1)), active_masks=jnp.asarray(active),
                         available_actions=None)
    key = jax.random.PRNGKey(seed + 11)
    jstate, jstats = jactor.update(jcommon.AgentTrainState(params, tx.init(params)), jbatch,
                                   jnp.asarray(adv), jnp.asarray(factor), key)

    tpol = StochasticPolicy(OBS_DIM, spaces.Box.create(-1.0, 1.0, ACT_DIM), HIDDEN,
                            device="cpu")
    tpol.load_state_dict(convert.policy_state_dict(_np_tree(params)))
    tstate = tcommon.AgentTrainState(
        tpol, tcommon.make_optimizer(tpol.parameters(), LR, EPS, 0.0, MAX_NORM))
    tactor = HAPPOActor(spaces.Box.create(-1.0, 1.0, ACT_DIM), cfg)
    perms = (None if num_mini_batch == 1 else
             torch.from_numpy(_jax_perms(key, CFG["ppo_epoch"], T * B)).long())
    tbatch = ActorBatch(obs=torch.from_numpy(obs), actions=torch.from_numpy(actions),
                        logp=torch.from_numpy(logp), active_masks=torch.from_numpy(active))
    tstats = tactor.update(tstate, tbatch, torch.from_numpy(adv), torch.from_numpy(factor),
                           perms)
    return (jactor, jstate, jstats, jbatch), (tactor, tstate, tstats, tbatch)


@pytest.mark.parametrize("num_mini_batch", [1, 2])
def test_happo_actor_update_matches(num_mini_batch):
    (jactor, jstate, jstats, jbatch), (tactor, tstate, tstats, tbatch) = _actor_case(
        num_mini_batch)
    # [policy_loss, dist_entropy, grad_norm, ratio] averaged over steps
    _close(tstats, jstats, STAT_RTOL, STAT_ATOL)
    assert float(jstats[2]) > 0.0
    _same_params(tstate.net, jstate.params, convert.policy_state_dict)
    # the factor chain's full-batch log-probs with the new parameters
    _close(tactor.evaluate_logp(tstate.net, tbatch), jactor.evaluate_logp(jstate.params, jbatch),
           PARAM_RTOL, PARAM_ATOL)


def test_happo_actor_needs_perms_for_minibatches():
    cfg = dict(CFG, actor_num_mini_batch=2)
    tactor = HAPPOActor(spaces.Box.create(-1.0, 1.0, ACT_DIM), cfg)
    tpol = StochasticPolicy(OBS_DIM, spaces.Box.create(-1.0, 1.0, ACT_DIM), HIDDEN,
                            device="cpu")
    st = tcommon.AgentTrainState(tpol, tcommon.make_optimizer(tpol.parameters(), LR))
    z = torch.zeros((T, B, 1))
    batch = ActorBatch(torch.zeros((T, B, OBS_DIM)), torch.zeros((T, B, ACT_DIM)),
                       torch.zeros((T, B, ACT_DIM)), torch.ones((T, B, 1)))
    with pytest.raises(ValueError):
        tactor.update(st, batch, z, z + 1, None)


def _critic_case(num_mini_batch, seed=1):
    rng = np.random.default_rng(seed)
    f = np.float32
    jnet = JVNet(hidden_sizes=HIDDEN)
    share = rng.normal(size=(T, B, DS)).astype(f)
    params = jnet.init(jax.random.PRNGKey(seed), jnp.asarray(share[0]))
    params = jax.tree.map(lambda x: x + 0.2 * rng.normal(size=x.shape).astype(f), params)
    value_preds = rng.normal(size=(T, B, 1)).astype(f)
    returns = rng.normal(2.0, 3.0, size=(T, B, 1)).astype(f)
    # a ValueNorm that has seen a few batches already
    jv, tv = jvn.init_value_norm(1), tvn.init_value_norm(1, device="cpu")
    for _ in range(3):
        x = rng.normal(1.0, 2.0, size=(32, 1)).astype(f)
        jv = jvn.update_value_norm(jv, jnp.asarray(x))
        tv = tvn.update_value_norm(tv, torch.from_numpy(x))
    cfg = dict(CFG, critic_num_mini_batch=num_mini_batch)
    tx = jcommon.make_optimizer(LR, EPS, 0.0, MAX_NORM)
    jcritic = JVCritic(jnet, tx, cfg)
    key = jax.random.PRNGKey(seed + 5)
    jbatch = JCriticBatch(share_obs=jnp.asarray(share), rnn_states=jnp.zeros((T, B, 1, 16)),
                          value_preds=jnp.asarray(value_preds), returns=jnp.asarray(returns),
                          masks=jnp.ones((T, B, 1)))
    jstate, jv_new, jstats = jcritic.update(
        jcommon.AgentTrainState(params, tx.init(params)), jv, jbatch, key)

    tnet = VNet(DS, HIDDEN, device="cpu")
    tnet.load_state_dict(convert.vnet_state_dict(_np_tree(params)))
    tstate = tcommon.AgentTrainState(
        tnet, tcommon.make_optimizer(tnet.parameters(), LR, EPS, 0.0, MAX_NORM))
    tcritic = VCritic(cfg)
    perms = (None if num_mini_batch == 1 else
             torch.from_numpy(_jax_perms(key, CFG["critic_epoch"], T * B)).long())
    tbatch = CriticBatch(share_obs=torch.from_numpy(share),
                         value_preds=torch.from_numpy(value_preds),
                         returns=torch.from_numpy(returns))
    tv_new, tstats = tcritic.update(tstate, tv, tbatch, perms)
    return params, tv, (jstate, jv_new, jstats), (tcritic, tstate, tv_new, tstats, tbatch)


@pytest.mark.parametrize("num_mini_batch", [1, 2])
def test_v_critic_update_matches(num_mini_batch):
    _, _, (jstate, jv, jstats), (_, tstate, tv, tstats, _) = _critic_case(num_mini_batch)
    _close(tstats, jstats, STAT_RTOL, STAT_ATOL)   # [value_loss, grad_norm]
    _same_params(tstate.net, jstate.params, convert.vnet_state_dict)
    for name in ("running_mean", "running_mean_sq", "debiasing_term"):
        _close(getattr(tv, name), getattr(jv, name), 1e-5, 1e-7)


def test_value_norm_is_updated_before_the_critic_loss():
    """The reported loss of a single-minibatch epoch is the loss under the
    ValueNorm that has already taken that minibatch's returns."""
    params, tv_old, (_, _, jstats), (tcritic, _, _, _, tbatch) = _critic_case(1)
    tnet = VNet(DS, HIDDEN, device="cpu")
    tnet.load_state_dict(convert.vnet_state_dict(_np_tree(params)))
    with torch.no_grad():
        values = tnet(tbatch.share_obs.reshape(-1, DS))
        vp, ret = tbatch.value_preds.reshape(-1, 1), tbatch.returns.reshape(-1, 1)
        before = tcritic.value_loss(values, vp, ret, tvn.update_value_norm(tv_old, ret))
        stale = tcritic.value_loss(values, vp, ret, tv_old)
    # CFG has two epochs: the first epoch's loss is the one under test here
    cfg1 = dict(CFG, critic_epoch=1, critic_num_mini_batch=1)
    tstate = tcommon.AgentTrainState(tnet, tcommon.make_optimizer(tnet.parameters(), LR))
    _, stats = VCritic(cfg1).update(tstate, tv_old, tbatch)
    _close(stats[0], before, 1e-6, 1e-6)
    assert abs(float(stale) - float(before)) > 1e-3
    assert np.isfinite(np.asarray(jstats)).all()


def test_clip_matches_optax_not_clip_grad_norm():
    """optax scales by max/norm above the limit; torch's clip_grad_norm_
    by max/(norm + 1e-6), visibly different at a small limit."""
    rng = np.random.default_rng(3)
    grads = [rng.normal(size=s).astype(np.float32) * 1e-3 for s in [(4, 3), (3,)]]
    max_norm = 1e-3
    ref, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    tg = [torch.from_numpy(g.copy()) for g in grads]
    gnorm = tcommon.global_grad_norm(tg)
    _close(gnorm, optax.global_norm([jnp.asarray(g) for g in grads]), 1e-6, 0)
    assert float(gnorm) > max_norm
    tcommon.clip_by_global_norm_(tg, gnorm, max_norm)
    for a, b in zip(tg, ref):
        _close(a, b, 1e-6, 0)
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    torch.nn.utils.clip_grad_norm_(params, max_norm)
    rel = max(float((p.grad - a).abs().max() / a.abs().max()) for p, a in zip(params, tg))
    assert rel > 1e-4
    # below the limit both leave the gradients alone
    small = [torch.from_numpy(g.copy()) for g in grads]
    tcommon.clip_by_global_norm_(small, tcommon.global_grad_norm(small), 1.0)
    for a, g in zip(small, grads):
        np.testing.assert_array_equal(a.numpy(), g)


def test_losses_and_aggregation_match():
    rng = np.random.default_rng(4)
    e = rng.normal(0, 15.0, size=(50,)).astype(np.float32)
    _close(tcommon.huber_loss(torch.from_numpy(e), 10.0), jcommon.huber_loss(jnp.asarray(e), 10.0),
           1e-6, 1e-6)
    _close(tcommon.mse_loss(torch.from_numpy(e)), jcommon.mse_loss(jnp.asarray(e)), 1e-6, 1e-6)
    d = rng.normal(0, 0.2, size=(7, 3)).astype(np.float32)
    for how in ("prod", "mean"):
        _close(tcommon.aggregate_ratio(torch.from_numpy(d), how),
               jcommon.aggregate_ratio(jnp.asarray(d), how), 1e-6, 1e-6)
    with pytest.raises(ValueError):
        tcommon.aggregate_ratio(torch.from_numpy(d), "max")
