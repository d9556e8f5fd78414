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
from harl_tpu.models.mlp import MLPBase as JMLPBase
from harl_tpu.models.policies import StochasticPolicy as JPolicy
from harl_tpu.models.values import VNet as JVNet
from harl_tpu.utils import spaces as jspaces
from harl_tpu.utils.config_tools import get_defaults_yaml_args as jdefaults
from harl_tpu_torch.models import act as tact
from harl_tpu_torch.models.mlp import LAYER_NORM_EPS, MLPBase
from harl_tpu_torch.models.policies import StochasticPolicy
from harl_tpu_torch.models.values import VNet
from harl_tpu_torch.utils import convert, spaces
from harl_tpu_torch.utils.config_tools import get_defaults_yaml_args

# float32 forward passes of two small layers; sums in another order
RTOL = ATOL = 1e-5
OBS_DIM, ACT_DIM, HIDDEN = 12, 3, (16, 16)


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
    tmean, tlog_std = tpol(torch.from_numpy(obs))
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
    head = tpol(torch.from_numpy(obs))
    out = tact.act_sample(None, head, spaces.Box.create(-1.0, 1.0, ACT_DIM), deterministic=True)
    _close(out.actions.detach(), head[0].detach())


def test_vnet_matches_flax():
    jv = JVNet(hidden_sizes=HIDDEN)
    x = np.random.default_rng(2).normal(size=(7, 20)).astype(np.float32)
    params = _perturbed(jv.init(jax.random.PRNGKey(2), jnp.asarray(x)), 3)
    tv = VNet(20, HIDDEN, device="cpu")
    tv.load_state_dict(convert.vnet_state_dict(params))
    jout, _ = jv.apply(params, jnp.asarray(x))
    _close(tv(torch.from_numpy(x)).detach(), jout)


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
    with pytest.raises(NotImplementedError):
        StochasticPolicy(OBS_DIM, spaces.Discrete(5), HIDDEN, device="cpu")
    with pytest.raises(NotImplementedError):
        StochasticPolicy(OBS_DIM, spaces.Box.create(-1.0, 1.0, 2), HIDDEN, device="cpu",
                         use_recurrent_policy=True)


@pytest.mark.parametrize("section", ["train", "model", "algo"])
def test_happo_yaml_copy_matches(section):
    port, _ = get_defaults_yaml_args("happo", "mamujoco_jax")
    ref, _ = jdefaults("happo", "mamujoco_jax")
    assert port[section] == ref[section]
