"""Port parity: networks, action heads and the parameter converter.

Flax modules of ``harl_tpu.models`` are initialised, their parameters are
perturbed (so no output is trivially zero) and copied into the port's
modules through ``harl_tpu_torch.utils.convert``; both sides then see the
same observations and the same Gaussian noise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harl_tpu.models import act as jact
from harl_tpu.ops import distributions as jdist
from harl_tpu.models.mlp import MLPBase as JMLPBase
from harl_tpu.models.policies import StochasticPolicy as JPolicy
from harl_tpu.models.values import VNet as JVNet
from harl_tpu.utils import spaces as jspaces
from harl_tpu.utils.config_tools import get_defaults_yaml_args as jdefaults
from harl_tpu_torch.models import act as tact
from harl_tpu_torch.models.mlp import LAYER_NORM_EPS, MLPBase
from harl_tpu_torch.models.policies import StochasticPolicy
from harl_tpu_torch.models.values import VNet
from harl_tpu_torch.ops import distributions as tdist
from harl_tpu_torch.utils import convert, spaces
from harl_tpu_torch.utils.config_tools import get_defaults_yaml_args

# float32 forward passes of two small layers; sums in another order
RTOL = ATOL = 1e-5
OBS_DIM, ACT_DIM, HIDDEN = 12, 3, (16, 16)
N_ACT = 7


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _perturbed(params, seed):
    """numpy copy of a flax tree with every leaf moved by N(0, 0.3²)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.3 * rng.normal(size=x.shape)).astype(np.float32), params)


def _policies(seed=0):
    jpol = JPolicy(action_space=jspaces.Box.create(-1.0, 1.0, ACT_DIM), hidden_sizes=HIDDEN)
    obs = np.random.default_rng(seed).normal(size=(5, OBS_DIM)).astype(np.float32)
    params = _perturbed(jpol.init(jax.random.PRNGKey(seed), jnp.asarray(obs)), seed + 1)
    tpol = StochasticPolicy(OBS_DIM, spaces.Box.create(-1.0, 1.0, ACT_DIM), HIDDEN,
                            device="cpu")
    tpol.load_state_dict(convert.policy_state_dict(params))
    return jpol, params, tpol, obs


def test_policy_sample_and_evaluate_match_flax():
    jpol, params, tpol, obs = _policies()
    noise = np.random.default_rng(7).normal(size=(5, ACT_DIM)).astype(np.float32)
    (jmean, jlog_std), _ = jpol.apply(params, jnp.asarray(obs))
    (tmean, tlog_std), rnn = tpol(torch.from_numpy(obs))
    assert rnn is None
    _close(tmean.detach(), jmean)
    _close(tlog_std.detach(), jlog_std)
    # the JAX sample draws its own normal; rebuild it from the same noise
    jstd = jact.D.diag_gaussian_std(jlog_std, 1.0, 0.5)
    jaction = jmean + jstd * noise
    jlp = jact.D.DiagGaussian(jmean, jstd).log_prob(jaction)
    out = tact.act_sample(torch.from_numpy(noise), (tmean, tlog_std),
                          spaces.Box.create(-1.0, 1.0, ACT_DIM))
    _close(out.actions.detach(), jaction)
    _close(out.log_probs.detach(), jlp)
    active = np.array([[1.0], [0.0], [1.0], [1.0], [0.0]], np.float32)
    jev = jact.act_evaluate((jmean, jlog_std), jspaces.Box.create(-1.0, 1.0, ACT_DIM),
                            jaction, active_masks=jnp.asarray(active))
    tev = tact.act_evaluate((tmean, tlog_std), spaces.Box.create(-1.0, 1.0, ACT_DIM),
                            out.actions, active_masks=torch.from_numpy(active))
    _close(tev.log_probs.detach(), jev.log_probs)
    _close(tev.entropy.detach(), jev.entropy)
    tev_all = tact.act_evaluate((tmean, tlog_std), spaces.Box.create(-1.0, 1.0, ACT_DIM),
                                out.actions)
    jev_all = jact.act_evaluate((jmean, jlog_std), jspaces.Box.create(-1.0, 1.0, ACT_DIM),
                                jaction)
    _close(tev_all.entropy.detach(), jev_all.entropy)


def test_deterministic_sample_is_the_mean():
    _, _, tpol, obs = _policies(1)
    head, _ = tpol(torch.from_numpy(obs))
    out = tact.act_sample(None, head, spaces.Box.create(-1.0, 1.0, ACT_DIM), deterministic=True)
    _close(out.actions.detach(), head[0].detach())


def test_vnet_matches_flax():
    jv = JVNet(hidden_sizes=HIDDEN)
    x = np.random.default_rng(2).normal(size=(7, 20)).astype(np.float32)
    params = _perturbed(jv.init(jax.random.PRNGKey(2), jnp.asarray(x)), 3)
    tv = VNet(20, HIDDEN, device="cpu")
    tv.load_state_dict(convert.vnet_state_dict(params))
    jout, _ = jv.apply(params, jnp.asarray(x))
    tout, rnn = tv(torch.from_numpy(x))
    assert rnn is None
    _close(tout.detach(), jout)


def test_layer_norm_eps_is_flax_default():
    """Features with a variance near 1e-6 separate eps=1e-6 (flax) from
    torch's default 1e-5 by far more than the tolerance."""
    jm = JMLPBase(hidden_sizes=(8,))
    x = (1e-3 * np.random.default_rng(3).normal(size=(4, 6))).astype(np.float32)
    params = _perturbed(jm.init(jax.random.PRNGKey(3), jnp.asarray(x)), 4)
    tm = MLPBase(6, (8,), device="cpu")
    sd = convert.policy_state_dict(
        {"base": params["params"], "act": {"head": {"kernel": np.zeros((8, 1), np.float32),
                                                     "bias": np.zeros(1, np.float32)},
                                            "log_std": np.zeros(1, np.float32)}})
    tm.load_state_dict({k[len("base."):]: v for k, v in sd.items() if k.startswith("base.")})
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    assert LAYER_NORM_EPS == 1e-6
    assert all(ln.eps == 1e-6 for ln in [tm.feature_norm, *tm.ln])
    _close(tm(torch.from_numpy(x)).detach(), ref)
    for ln in [tm.feature_norm, *tm.ln]:
        ln.eps = 1e-5
    wrong = tm(torch.from_numpy(x)).detach().numpy()
    assert np.abs(wrong - ref).max() > 1e-2


def test_convert_transposes_dense_kernels():
    _, params, tpol, _ = _policies(4)
    p = params["params"]
    sd = tpol.state_dict()
    # hidden layer 1 is square (16x16): only the transpose makes it right
    kernel = p["base"]["fc1"]["kernel"]
    np.testing.assert_array_equal(sd["base.fc.1.weight"].numpy(), kernel.T)
    assert not np.allclose(kernel, kernel.T)
    np.testing.assert_array_equal(sd["base.fc.0.weight"].numpy(), p["base"]["fc0"]["kernel"].T)
    np.testing.assert_array_equal(sd["act.head.weight"].numpy(), p["act"]["head"]["kernel"].T)
    np.testing.assert_array_equal(sd["base.ln.0.weight"].numpy(), p["base"]["ln0"]["scale"])
    np.testing.assert_array_equal(sd["base.feature_norm.bias"].numpy(),
                                  p["base"]["feature_norm"]["bias"])
    np.testing.assert_array_equal(sd["act.log_std"].numpy(), p["act"]["log_std"])


def test_fresh_init_statistics():
    """Orthogonal init with the activation's gain, zero biases, log_std at
    std_x_coef — the init statistics of the JAX package, not its values."""
    gen = torch.Generator().manual_seed(0)
    tpol = StochasticPolicy(OBS_DIM, spaces.Box.create(-1.0, 1.0, ACT_DIM), HIDDEN,
                            device="cpu", generator=gen)
    w = tpol.base.fc[1].weight.detach()
    _close(w @ w.T, 2.0 * np.eye(16), atol=1e-5)   # relu gain sqrt(2), squared
    h = tpol.act.head.weight.detach()
    _close(h @ h.T, 1e-4 * np.eye(ACT_DIM), atol=1e-9)  # gain 0.01
    assert float(tpol.base.fc[0].bias.detach().abs().sum()) == 0.0
    _close(tpol.act.log_std.detach(), np.ones(ACT_DIM))


def test_unported_heads_raise():
    class MultiDiscrete:   # several categoricals, as the JAX package's space
        nvec = (3, 4)

    # MultiDiscrete heads, refused before, build (tests/test_torch_multidiscrete_cnn.py)
    head = StochasticPolicy(OBS_DIM, MultiDiscrete(), HIDDEN, device="cpu").act
    assert [getattr(head, f"head{i}").out_features for i in range(2)] == [3, 4]
    # the non-orthogonal inits, refused before, build (tests/test_torch_options.py);
    # an unknown one raises, as in the JAX package
    StochasticPolicy(OBS_DIM, spaces.Discrete(5), HIDDEN, device="cpu",
                     initialization_method="xavier_uniform_", use_recurrent_policy=True)
    with pytest.raises(ValueError, match="Unknown initialization method"):
        StochasticPolicy(OBS_DIM, spaces.Discrete(5), HIDDEN, device="cpu",
                         initialization_method="glorot_")


@pytest.mark.parametrize("section", ["train", "model", "algo"])
def test_happo_yaml_copy_matches(section):
    port, _ = get_defaults_yaml_args("happo", "mamujoco_jax")
    ref, _ = jdefaults("happo", "mamujoco_jax")
    assert port[section] == ref[section]


# ----------------------------------------------------- Discrete, recurrent
def _avail(rng, shape):
    """Availability rows with some actions masked and at least one free."""
    avail = (rng.uniform(size=shape) > 0.4).astype(np.float32)
    avail[..., 1] = 1.0
    return avail


def test_categorical_with_availability_matches_jax():
    """Masked log-probs and entropy (no NaN from the −1e10 logits), the
    Gumbel-max sample equal to ``jax.random.categorical`` for the same key,
    and never an unavailable action."""
    rng = np.random.default_rng(5)
    logits = (3.0 * rng.normal(size=(64, N_ACT))).astype(np.float32)
    avail = _avail(rng, (64, N_ACT))
    key = jax.random.PRNGKey(5)
    jd = jdist.categorical(jnp.asarray(logits), jnp.asarray(avail))
    td = tdist.categorical(torch.from_numpy(logits), torch.from_numpy(avail))
    gumbel = np.array(jax.random.gumbel(key, logits.shape))
    ja = np.asarray(jd.sample(key))
    ta = td.sample(torch.from_numpy(gumbel))
    np.testing.assert_array_equal(ta.numpy(), ja)
    assert (np.take_along_axis(avail, ta.numpy(), -1) == 1).all()
    np.testing.assert_array_equal(td.mode().numpy(), np.asarray(jd.mode()))
    _close(td.log_prob(ta), jd.log_prob(jnp.asarray(ja)))
    ent = td.entropy()
    assert bool(torch.isfinite(ent).all())
    _close(ent, jd.entropy())
    # every action but one masked: p = 0 exactly for the rest, entropy 0
    one = np.zeros((1, N_ACT), np.float32)
    one[0, 2] = 1.0
    _close(tdist.categorical(torch.from_numpy(logits[:1]), torch.from_numpy(one)).entropy(),
           np.zeros(1))


def test_discrete_head_sample_and_evaluate_match_flax():
    rng = np.random.default_rng(6)
    space, jspace = spaces.Discrete(N_ACT), jspaces.Discrete(N_ACT)
    jpol = JPolicy(action_space=jspace, hidden_sizes=HIDDEN)
    obs = rng.normal(size=(9, OBS_DIM)).astype(np.float32)
    params = _perturbed(jpol.init(jax.random.PRNGKey(6), jnp.asarray(obs)), 7)
    tpol = StochasticPolicy(OBS_DIM, space, HIDDEN, device="cpu")
    tpol.load_state_dict(convert.policy_state_dict(params))
    avail = _avail(rng, (9, N_ACT))
    key = jax.random.PRNGKey(8)
    jhead, _ = jpol.apply(params, jnp.asarray(obs))
    thead, _ = tpol(torch.from_numpy(obs))
    _close(thead[0].detach(), jhead[0])
    jout = jact.act_sample(key, jhead, jspace, jnp.asarray(avail))
    tout = tact.act_sample(torch.from_numpy(np.array(jax.random.gumbel(key, (9, N_ACT)))),
                           thead, space, torch.from_numpy(avail))
    np.testing.assert_array_equal(tout.actions.numpy(), np.asarray(jout.actions))
    _close(tout.log_probs.detach(), jout.log_probs)
    active = (rng.uniform(size=(9, 1)) > 0.3).astype(np.float32)
    jev = jact.act_evaluate(jhead, jspace, jout.actions, jnp.asarray(avail), jnp.asarray(active))
    tev = tact.act_evaluate(thead, space, tout.actions, torch.from_numpy(avail),
                            torch.from_numpy(active))
    _close(tev.log_probs.detach(), jev.log_probs)
    _close(tev.entropy.detach(), jev.entropy)


@pytest.mark.parametrize("seq", [False, True])
def test_recurrent_policy_and_vnet_match_flax(seq):
    """MLP → GRU → head, in step mode and in sequence mode over 12 steps
    with masks that reset some hidden states midway."""
    rng = np.random.default_rng(9)
    T, B, Hd = 12, 5, HIDDEN[-1]
    space, jspace = spaces.Discrete(N_ACT), jspaces.Discrete(N_ACT)
    x = rng.normal(size=(T, B, OBS_DIM)).astype(np.float32)
    h0 = rng.normal(size=(B, 1, Hd)).astype(np.float32)
    masks = (rng.uniform(size=(T, B, 1)) > 0.2).astype(np.float32)
    xi, mi = (x, masks) if seq else (x[0], masks[0])
    jpol = JPolicy(action_space=jspace, hidden_sizes=HIDDEN, use_recurrent_policy=True)
    jv = JVNet(hidden_sizes=HIDDEN, use_recurrent_policy=True)
    for jm, to_sd, make in [
        (jpol, convert.policy_state_dict,
         lambda: StochasticPolicy(OBS_DIM, space, HIDDEN, use_recurrent_policy=True,
                                  device="cpu")),
        (jv, convert.vnet_state_dict,
         lambda: VNet(OBS_DIM, HIDDEN, use_recurrent_policy=True, device="cpu")),
    ]:
        params = _perturbed(jm.init(jax.random.PRNGKey(9), jnp.asarray(x[0])), 10)
        tm = make()
        tm.load_state_dict(to_sd(params))
        jout, jh = jm.apply(params, jnp.asarray(xi), jnp.asarray(h0), jnp.asarray(mi), seq=seq)
        with torch.no_grad():
            tout, th = tm(torch.from_numpy(xi), torch.from_numpy(h0), torch.from_numpy(mi),
                          seq=seq)
        for a, b in zip(tout if isinstance(tout, tuple) else (tout,),
                        jout if isinstance(jout, tuple) else (jout,)):
            _close(a, b)
        _close(th, jh)
    # the converter carries the GRU and the Discrete head
    sd = convert.policy_state_dict(_perturbed(jpol.init(jax.random.PRNGKey(9),
                                                        jnp.asarray(x[0])), 10))
    assert {"rnn.wi0", "rnn.wh0", "rnn.bi0", "rnn.bh0", "rnn.norm.weight",
            "act.head.weight"} <= set(sd) and "act.log_std" not in sd


@pytest.mark.parametrize("in_dim,out_dim", [(19, 8), (8, 1), (64, 64), (256, 256)])
def test_linear_rows_do_not_depend_on_the_batch_width(in_dim, out_dim):
    """A layer's rows and its input's gradient rows on the CPU are bitwise
    the same at every width from 1 to 64 rows (MKL's ``F.linear`` picks
    its kernel by the number of rows and rounds a lone row apart), and
    equal ``F.linear`` to float32 rounding."""
    from harl_tpu_torch.models.mlp import make_linear

    g = torch.Generator().manual_seed(in_dim)
    layer = make_linear(in_dim, out_dim, lambda w, gen: torch.nn.init.normal_(w, generator=gen),
                        "cpu", g)
    with torch.no_grad():
        layer.bias.normal_(generator=g)
    x = torch.randn(64, in_dim, generator=g, requires_grad=True)
    dy = torch.randn(64, out_dim, generator=g)
    full = layer(x)
    (dx,) = torch.autograd.grad(full, x, dy)
    for m in range(1, 64):
        xm = x.detach()[:m].requires_grad_()
        ym = layer(xm)
        (dxm,) = torch.autograd.grad(ym, xm, dy[:m])
        assert torch.equal(ym, full[:m]) and torch.equal(dxm, dx[:m]), m
    plain = torch.nn.functional.linear(x, layer.weight, layer.bias)
    torch.testing.assert_close(full, plain, rtol=1e-5, atol=1e-5 * in_dim ** 0.5)
    assert layer(x.detach()[:5, None]).shape == (5, 1, out_dim)


def test_row_product_gradients():
    """The row product's first and second derivatives (HATRPO's
    Fisher-vector products differentiate twice), in float64."""
    from harl_tpu_torch.models.mlp import _RowProduct

    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 7, generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn(3, 7, generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(_RowProduct.apply, (x, w))
    assert torch.autograd.gradgradcheck(_RowProduct.apply, (x, w))
