"""Port parity: the HATRPO actor update (``harl_tpu_torch/algos/hatrpo.py``)
against the JAX package's ``HATRPOActor.update``.

Both sides start from the same parameters (flax → ``convert``) and see the
same batch. The JAX side takes its Fisher-vector products forward over
reverse, the port reverse over reverse, and the dot products sum in another
order (``ravel_pytree`` against ``parameters_to_vector``), so the conjugate
gradient's iterates agree to float32 rounding, not bitwise.

The line search's accepted step is compared exactly: the port reports its
fraction and each try's (kl, improvement, expected improvement); the JAX
update, rerun with ``ls_step`` cut to the port's accepted try and to one try
fewer, must accept in the first and roll back in the second. The seeds below
were chosen so that no decision is marginal: every condition of every try is
at least ``MARGIN`` (relative) away from its threshold, which the test
asserts, so float32 rounding cannot flip one. They were also chosen so that
the conjugate gradient does not end near its 1e-10 residual, where one side
could stop an iteration before the other: on these seeds the updated
parameters agree to ~1e-6, well inside the tolerance.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harl_tpu.algos import common as jcommon
from harl_tpu.algos.happo import ActorBatch as JActorBatch
from harl_tpu.algos.hatrpo import HATRPOActor as JHATRPO
from harl_tpu.models.policies import StochasticPolicy as JPolicy
from harl_tpu.utils import spaces as jspaces
from harl_tpu_torch.algos import common as tcommon
from harl_tpu_torch.algos.happo import ActorBatch
from harl_tpu_torch.algos.hatrpo import HATRPOActor
from harl_tpu_torch.models.policies import StochasticPolicy
from harl_tpu_torch.utils import convert, spaces

# Parameters after one trust-region step: the step is the CG solution
# scaled to the KL radius, and CG amplifies float32 rounding in the FVPs.
PARAM_RTOL, PARAM_ATOL = 1e-3, 1e-5
# [improvement, entropy, kl, ratio]: the improvement and the KL are small
# differences of full-batch float32 sums.
STAT_RTOL, STAT_ATOL = 1e-4, 1e-6
MARGIN = 0.02
T, B, OBS_DIM, ACT_DIM, N_ACT, H = 8, 6, 10, 3, 5, 16
CFG = dict(kl_threshold=0.01, ls_step=10, accept_ratio=0.5, backtrack_coeff=0.8,
           use_policy_active_masks=True, action_aggregation="prod", std_x_coef=1.0,
           std_y_coef=0.5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _case(kind, seed):
    """(jax policy, jax space, port space, params, numpy batch, cfg)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    recurrent = kind == "recurrent"
    if kind == "box":
        jspace, space = jspaces.Box.create(-1.0, 1.0, ACT_DIM), spaces.Box.create(-1.0, 1.0,
                                                                                  ACT_DIM)
    else:
        jspace, space = jspaces.Discrete(N_ACT), spaces.Discrete(N_ACT)
    jpol = JPolicy(action_space=jspace, hidden_sizes=(H, H), use_recurrent_policy=recurrent)
    obs = rng.normal(size=(T, B, OBS_DIM)).astype(f)
    params = jpol.init(jax.random.PRNGKey(seed), jnp.asarray(obs[0]))
    params = jax.tree.map(lambda x: x + 0.2 * rng.normal(size=x.shape).astype(f), params)
    rnn = rng.normal(size=(T, B, 1, H)).astype(f)
    masks = (rng.uniform(size=(T, B, 1)) > 0.2).astype(f)
    if recurrent:
        head, _ = jpol.apply(params, jnp.asarray(obs), jnp.asarray(rnn[0]), jnp.asarray(masks),
                             seq=True)
    else:
        head, _ = jpol.apply(params, jnp.asarray(obs))
    avail = None
    if kind == "box":
        mean, log_std = head
        actions = rng.uniform(-1, 1, size=(T, B, ACT_DIM)).astype(f)
        std = jax.nn.sigmoid(log_std) * 0.5
        logp = np.asarray(-((actions - mean) ** 2) / (2 * std ** 2) - jnp.log(std)
                          - 0.5 * np.log(2 * np.pi))
    else:
        avail = (rng.uniform(size=(T, B, N_ACT)) > 0.3).astype(f)
        avail[..., 1] = 1.0
        actions = (rng.uniform(size=avail.shape) * avail).argmax(-1)[..., None].astype(np.int32)
        lp = jax.nn.log_softmax(jnp.where(avail == 0, -1e10, head[0]))
        logp = np.take_along_axis(np.asarray(lp), actions, -1)
    # behaviour log-probs slightly off the current policy: ratios near 1
    logp = (logp + 0.05 * rng.normal(size=logp.shape)).astype(f)
    batch = dict(obs=obs, actions=actions, logp=logp, masks=masks, rnn=rnn,
                 active=(rng.uniform(size=(T, B, 1)) > 0.2).astype(f),
                 adv=rng.normal(0.3, 1.5, size=(T, B, 1)).astype(f),
                 factor=rng.uniform(0.7, 1.3, size=(T, B, 1)).astype(f), avail=avail)
    cfg = dict(CFG, use_recurrent_policy=recurrent)
    return jpol, jspace, space, params, batch, cfg


def _jax_update(jpol, jspace, params, b, cfg, state_type, ls_step=None):
    cfg = dict(cfg) if ls_step is None else dict(cfg, ls_step=ls_step)
    tx = jcommon.make_optimizer(5e-4)
    actor = JHATRPO(jpol, jspace, tx, cfg)
    jb = JActorBatch(obs=jnp.asarray(b["obs"]), rnn_states=jnp.asarray(b["rnn"]),
                     actions=jnp.asarray(b["actions"]), logp=jnp.asarray(b["logp"]),
                     masks=jnp.asarray(b["masks"]), active_masks=jnp.asarray(b["active"]),
                     available_actions=None if b["avail"] is None else jnp.asarray(b["avail"]))
    st, stats = actor.update(jcommon.AgentTrainState(params, tx.init(params)), jb,
                             jnp.asarray(b["adv"]), jnp.asarray(b["factor"]), None, state_type)
    return st.params, np.asarray(stats)


def _torch_update(space, params, b, cfg, state_type):
    recurrent = cfg["use_recurrent_policy"]
    pol = StochasticPolicy(OBS_DIM, space, (H, H), use_recurrent_policy=recurrent, device="cpu")
    pol.load_state_dict(convert.policy_state_dict(_np_tree(params)))
    state = tcommon.AgentTrainState(pol, tcommon.make_optimizer(pol.parameters(), 5e-4))
    actor = HATRPOActor(space, cfg)
    t = torch.from_numpy
    batch = ActorBatch(obs=t(b["obs"]), actions=t(b["actions"]).long()
                       if b["avail"] is not None else t(b["actions"]),
                       logp=t(b["logp"]), active_masks=t(b["active"]),
                       rnn_states=t(b["rnn"]), masks=t(b["masks"]),
                       available_actions=None if b["avail"] is None else t(b["avail"]))
    stats = actor.update(state, batch, t(b["adv"]), t(b["factor"]), state_type=state_type)
    return actor, pol, stats


def _accepted_try(actor):
    """Index of the accepted try (None: rolled back), after checking that
    every decision of the search is at least MARGIN away from its threshold."""
    thr, ar = actor.kl_threshold, actor.accept_ratio
    for i, (kl, improve, expected) in enumerate(actor.last_tries):
        kl, improve, expected = float(kl), float(improve), float(expected)
        ratio = improve / expected
        good = (kl < thr * (1 - MARGIN), ratio > ar + MARGIN,
                improve > MARGIN * abs(expected))
        bad = (kl > thr * (1 + MARGIN), math.isnan(ratio) or ratio < ar - MARGIN,
               improve < -MARGIN * abs(expected))
        assert all(good) or any(bad), f"try {i} is marginal: kl {kl}, ratio {ratio}"
        if all(good):
            return i
    return None


# (kind, state type, seed, kl_threshold, backtrack_coeff): with the YAML's
# radius every seed accepts its first try; a wider radius makes the first
# try overshoot (its KL, or its improvement ratio), and the search accepts
# the second. None of these decisions is marginal (asserted in _accepted_try).
CASES = [("box", "EP", 0, 0.01, 0.8), ("box", "EP", 5, 0.1, 0.5),
         ("discrete", "EP", 2, 0.01, 0.8), ("discrete", "EP", 0, 2.0, 0.5),
         ("recurrent", "FP", 0, 0.01, 0.8), ("recurrent", "FP", 4, 0.01, 0.8)]


@pytest.mark.parametrize("kind,state_type,seed,kl_threshold,backtrack_coeff", CASES)
def test_hatrpo_update_matches_jax(kind, state_type, seed, kl_threshold, backtrack_coeff):
    jpol, jspace, space, params, b, cfg = _case(kind, seed)
    cfg = dict(cfg, kl_threshold=kl_threshold, backtrack_coeff=backtrack_coeff)
    jparams, jstats = _jax_update(jpol, jspace, params, b, cfg, state_type)
    actor, pol, tstats = _torch_update(space, params, b, cfg, state_type)

    k = _accepted_try(actor)
    assert k is not None, "the line search accepted nothing: pick another seed"
    fraction = np.float32(1.0)
    for _ in range(k):   # float32 products, as both line searches carry them
        fraction = fraction * np.float32(cfg["backtrack_coeff"])
    assert actor.last_fraction == float(fraction)
    # the JAX search accepts at the same try: with k + 1 tries it moves, with k not
    moved, _ = _jax_update(jpol, jspace, params, b, cfg, state_type, ls_step=k + 1)
    kept, kept_stats = _jax_update(jpol, jspace, params, b, cfg, state_type, ls_step=k)
    ref = convert.policy_state_dict(_np_tree(moved))
    for name, v in convert.policy_state_dict(_np_tree(jparams)).items():
        np.testing.assert_array_equal(v.numpy(), ref[name].numpy())
    before = convert.policy_state_dict(_np_tree(params))
    for name, v in convert.policy_state_dict(_np_tree(kept)).items():
        np.testing.assert_array_equal(v.numpy(), before[name].numpy())
    assert kept_stats[0] == 0.0 and kept_stats[2] == 0.0

    _close(tstats, jstats, STAT_RTOL, STAT_ATOL)
    assert 0.0 < float(tstats[2]) < cfg["kl_threshold"] and float(tstats[0]) > 0.0
    for name, v in pol.state_dict().items():
        _close(v, ref[name], PARAM_RTOL, PARAM_ATOL)
        assert not torch.equal(v, before[name]) or name.endswith("log_std")


def test_hatrpo_rolls_back_when_nothing_is_accepted():
    """An accept ratio above what every try reaches (recurrent, FP): all ten
    tries are refused, the parameters stay bitwise as they were, and the
    stats report 0 improvement and 0 KL, on both sides."""
    jpol, jspace, space, params, b, cfg = _case("recurrent", 5)
    cfg = dict(cfg, accept_ratio=1.02, backtrack_coeff=0.5)
    actor, pol, stats = _torch_update(space, params, b, cfg, "FP")
    assert _accepted_try(actor) is None
    assert actor.last_fraction == 0.0 and len(actor.last_tries) == cfg["ls_step"]
    before = convert.policy_state_dict(_np_tree(params))
    for name, v in pol.state_dict().items():
        assert torch.equal(v, before[name]), name
    assert float(stats[0]) == 0.0 and float(stats[2]) == 0.0
    jparams, jstats = _jax_update(jpol, jspace, params, b, cfg, "FP")
    for name, v in convert.policy_state_dict(_np_tree(jparams)).items():
        np.testing.assert_array_equal(v.numpy(), before[name].numpy())
    _close(stats, jstats, STAT_RTOL, STAT_ATOL)


def test_hatrpo_config_defaults_and_refusals():
    """HATRPO's YAML has no ppo_epoch, actor_num_mini_batch or entropy_coef
    (hatrpo.py:50-53)."""
    actor = HATRPOActor(spaces.Discrete(3), dict(CFG))
    assert (actor.ppo_epoch, actor.num_mini_batch, actor.entropy_coef) == (1, 1, 0.0)

    class MultiDiscrete:
        nvec = (2, 3)

    with pytest.raises(ValueError, match="continuous and discrete"):
        HATRPOActor(MultiDiscrete(), dict(CFG))
