"""Port parity: the options of the ported modules that the port refused
before — the four non-orthogonal inits, AdamW weight decay, ValueNorm's
``per_element_update``, ``PlainCNN`` and the ``impl="assoc"`` returns — each
against the JAX package on the same numpy-seeded inputs, and a replayed
HAPPO iteration with weight decay and a ``kaiming_uniform_`` net."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from harl_tpu.algos import common as jcommon
from harl_tpu.models import cnn as jcnn
from harl_tpu.models import mlp as jmlp
from harl_tpu.ops import returns as jret
from harl_tpu.ops import value_norm as jvn
from harl_tpu.runners.on_policy import OnPolicyRunner as JRunner
from harl_tpu_torch.algos import common as tcommon
from harl_tpu_torch.models import mlp as tmlp
from harl_tpu_torch.models.cnn import PlainCNN
from harl_tpu_torch.ops import returns as tret
from harl_tpu_torch.ops import value_norm as tvn
from harl_tpu_torch.runners.on_policy import OnPolicyRunner
from harl_tpu_torch.utils import convert

from tests.test_torch_runner import (ARGS, DOF, PARAM_ATOL, PARAM_RTOL, B, N, _close, _configs,
                                     _load, _queue_iteration)
from tests.torch_replay import ReplayNoise, reset_noise

INITS = ["xavier_uniform_", "xavier_normal_", "kaiming_uniform_", "kaiming_normal_"]
# a variance estimated from ~10^5 draws: its relative sampling error is
# about √(2/n) ≈ 0.5 %; both sides' estimates sit well within 3 %
VAR_RTOL = 0.03


def _flax_sample(name, shape):
    return np.asarray(jmlp.get_init(name, 0.01)(jax.random.PRNGKey(1), shape, jnp.float32))


@pytest.mark.parametrize("name", INITS)
@pytest.mark.parametrize("layer", ["dense", "conv"])
def test_inits_match_flax_statistics(name, layer):
    """Bounds and variance against flax's initializer at a sampling
    tolerance (the generators differ, so values cannot be compared); the
    truncated normals stop at ±2σ of the underlying normal; ``gain`` is
    ignored."""
    if layer == "dense":
        flax_shape, torch_shape = (400, 300), (300, 400)          # (in, out) / (out, in)
    else:
        flax_shape, torch_shape = (3, 3, 64, 128), (128, 64, 3, 3)  # HWIO / OIHW
    ref = _flax_sample(name, flax_shape)
    draws = []
    for gain in (0.01, 5.0):
        w = torch.empty(torch_shape)
        tmlp.get_init(name, gain)(w, torch.Generator().manual_seed(2))
        draws.append(w)
    assert torch.equal(draws[0], draws[1])           # gain ignored, as in JAX
    w = draws[0].numpy()
    np.testing.assert_allclose(w.var(), ref.var(), rtol=VAR_RTOL)
    scale, mode, dist = tmlp.VARIANCE_SCALING[name]
    receptive = int(np.prod(flax_shape[:-2]))
    fan_in, fan_out = flax_shape[-2] * receptive, flax_shape[-1] * receptive
    variance = scale / (fan_in if mode == "fan_in" else (fan_in + fan_out) / 2)
    np.testing.assert_allclose(w.var(), variance, rtol=VAR_RTOL)
    bound = (np.sqrt(3 * variance) if dist == "uniform"
             else 2 * np.sqrt(variance) / tmlp.TRUNCATED_STD)
    for x in (w, ref):
        assert np.abs(x).max() <= bound * (1 + 1e-6)
        assert np.abs(x).max() >= 0.98 * bound        # the tails reach the bound
    assert abs(w.mean()) < 0.02 * np.sqrt(variance)


def test_unknown_init_raises():
    with pytest.raises(ValueError, match="Unknown initialization method"):
        tmlp.get_init("glorot_", 1.0)


# optax rounds p − lr·(adam + wd·p) in float32, AdamW p·(1 − lr·wd) and
# then the Adam step: a few ulp of the parameters' scale (≈1) a step
ADAMW_ATOL = 1e-6


@pytest.mark.parametrize("use_linear_lr_decay", [False, True])
def test_adamw_matches_optax(use_linear_lr_decay):
    """make_optimizer with weight decay: the clip, then AdamW, with and
    without the linear lr decay, against optax.chain(clip_by_global_norm,
    adamw) over several steps, the clip active on some of them."""
    lr, eps, wd, max_norm, episodes, upi = 5e-3, 1e-5, 0.05, 1.0, 3, 2
    rng = np.random.default_rng(7)
    shapes = [(5, 4), (4,)]
    init = [rng.normal(size=sh).astype(np.float32) for sh in shapes]
    tx = jcommon.make_optimizer(lr, eps, wd, max_norm, use_linear_lr_decay, episodes, upi)
    jparams = [jnp.asarray(p) for p in init]
    jopt = tx.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    topt = tcommon.make_optimizer(tparams, lr, eps, wd, max_norm, use_linear_lr_decay,
                                  episodes, upi)
    assert isinstance(topt.adam, torch.optim.AdamW)
    clipped = 0
    for step in range(8):
        grads = [(rng.normal(size=sh) * (0.05 if step % 2 else 2.0)).astype(np.float32)
                 for sh in shapes]
        updates, jopt = tx.update([jnp.asarray(g) for g in grads], jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(tparams, grads):
            p.grad = torch.from_numpy(g)
        clipped += float(topt.step()) > max_norm
        for a, b in zip(tparams, jparams):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-6,
                                       atol=ADAMW_ATOL)
    assert 0 < clipped < 8


def test_per_element_update_matches_jax():
    rng = np.random.default_rng(3)
    jstate, tstate = jvn.init_value_norm(1), tvn.init_value_norm(1)
    for shape in [(7, 4, 1), (3, 5, 2, 1), (11, 1)]:
        x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
        jstate = jvn.update_value_norm(jstate, jnp.asarray(x), per_element_update=True)
        tstate = tvn.update_value_norm(tstate, torch.from_numpy(x), per_element_update=True)
        for name in ("running_mean", "running_mean_sq", "debiasing_term"):
            np.testing.assert_allclose(getattr(tstate, name).numpy(),
                                       np.asarray(getattr(jstate, name)), rtol=1e-6, atol=1e-8)
    x = torch.from_numpy(rng.normal(size=(2, 3, 1)).astype(np.float32))
    np.testing.assert_allclose(tvn.normalize(tstate, x).numpy(),
                               np.asarray(jvn.normalize(jstate, jnp.asarray(x.numpy()))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("activation", ["relu", "tanh"])
def test_plain_cnn_matches_flax(activation):
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, size=(2, 3, 6, 5, 3)).astype(np.float32)   # (…, H, W, C)
    jnet = jcnn.PlainCNN(out_dim=7, activation_func=activation)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tnet = PlainCNN((6, 5, 3), 7, activation)
    tnet.load_state_dict(convert.plain_cnn_state_dict(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        out = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jnet.apply(params, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    # flax's default inits: LeCun normal kernels, zero biases
    fresh = PlainCNN((6, 5, 3), 7, activation, generator=torch.Generator().manual_seed(0))
    assert not fresh.conv.bias.any() and not fresh.fc.bias.any()
    assert float(fresh.fc.weight.detach().abs().max()) <= 2 * (1 / (6 * 5 * 32)) ** 0.5 / 0.8796 + 1e-6


# The two scans compose the same affine maps in other trees: each element
# is a sum of at most T products of γλ-powers and deltas of order 1, summed
# in another order, and the JAX assoc and scan forms differ as much.
ASSOC_RTOL = ASSOC_ATOL = 1e-5


@pytest.mark.parametrize("trailing", [(6, 1), (4, 3, 1)], ids=["EP", "FP"])
@pytest.mark.parametrize("with_bad", [True, False])
@pytest.mark.parametrize("T", [1, 13, 64])
def test_assoc_returns_match_jax(T, with_bad, trailing):
    rng = np.random.default_rng(T)
    r = rng.normal(size=(T,) + trailing).astype(np.float32)
    v = rng.normal(size=(T + 1,) + trailing).astype(np.float32)
    m = (rng.random(size=(T + 1,) + trailing) > 0.15).astype(np.float32)
    bm = (rng.random(size=(T + 1,) + trailing) > 0.1).astype(np.float32) if with_bad else None
    j = lambda x: None if x is None else jnp.asarray(x)
    t = lambda x: None if x is None else torch.from_numpy(x)
    jgae = jret.compute_gae(j(r), j(v), j(m), j(bm), 0.99, 0.95, impl="assoc")
    tgae = tret.compute_gae(t(r), t(v), t(m), t(bm), 0.99, 0.95, impl="assoc")
    np.testing.assert_allclose(tgae.numpy(), np.asarray(jgae), rtol=ASSOC_RTOL, atol=ASSOC_ATOL)
    plain = tret.compute_gae(t(r), t(v), t(m), t(bm), 0.99, 0.95)
    np.testing.assert_allclose(tgae.numpy(), plain.numpy(), rtol=ASSOC_RTOL, atol=ASSOC_ATOL)
    jdr = jret.compute_discounted_returns(j(r), j(v), j(m), j(bm), j(v[-1]), 0.99, impl="assoc")
    tdr = tret.compute_discounted_returns(t(r), t(v), t(m), t(bm), t(v[-1]), 0.99,
                                          impl="assoc")
    np.testing.assert_allclose(tdr.numpy(), np.asarray(jdr), rtol=ASSOC_RTOL, atol=ASSOC_ATOL)
    plain = tret.compute_discounted_returns(t(r), t(v), t(m), t(bm), t(v[-1]), 0.99)
    np.testing.assert_allclose(tdr.numpy(), plain.numpy(), rtol=ASSOC_RTOL, atol=ASSOC_ATOL)


def test_unknown_returns_impl_raises():
    x = torch.zeros((2, 1, 1))
    with pytest.raises(ValueError, match="impl"):
        tret.compute_gae(x, torch.zeros((3, 1, 1)), torch.ones((3, 1, 1)), None, 0.9, 0.9,
                         impl="pallas")


def test_happo_iteration_with_adamw_and_kaiming_matches_jax():
    """One replayed HAPPO iteration (tests/test_torch_runner.py) with weight
    decay 1e-4 and ``kaiming_uniform_`` networks, the JAX weights carried
    over, at the runner tests' tolerances."""
    algo_args, env_args = _configs(True, 2, False, "prod")
    algo_args["model"].update(weight_decay=1e-4, initialization_method="kaiming_uniform_")
    jr = JRunner(ARGS, copy.deepcopy(algo_args), copy.deepcopy(env_args))
    js = jr.init_state(0)
    noise = ReplayNoise()
    _, k_env, *_ = jax.random.split(jax.random.PRNGKey(0), N + 2)
    noise.resets.append(reset_noise(jax.random.split(k_env, B), DOF))
    tr = OnPolicyRunner(ARGS, algo_args, env_args, device="cpu", noise=noise)
    ts = tr.init_state(0)
    assert isinstance(ts.actors[0].opt.adam, torch.optim.AdamW)
    for st, jst in zip(ts.actors, js.actors):
        _load(st.net, jst.params, convert.policy_state_dict)
    _load(ts.critic.net, js.critic.params, convert.vnet_state_dict)
    _queue_iteration(noise, js.rng, [sp.shape[0] for sp in jr.act_spaces], 2, 2, False)
    js2, jm = jr._train_iteration(js)
    ts, tm = tr.train_iteration(ts)
    assert noise.drained()
    _close(tm["actor_stats"], jm["actor_stats"])
    for k in ("value_loss", "critic_grad_norm"):
        _close(tm[k], jm[k])
    for st, jst in zip(ts.actors, js2.actors):
        ref = convert.policy_state_dict(jax.tree.map(np.asarray, jst.params))
        for k, v in st.net.state_dict().items():
            _close(v, ref[k], PARAM_RTOL, PARAM_ATOL)
    ref = convert.vnet_state_dict(jax.tree.map(np.asarray, js2.critic.params))
    for k, v in ts.critic.net.state_dict().items():
        _close(v, ref[k], PARAM_RTOL, PARAM_ATOL)
