"""Port parity: the off-policy networks, the squashed Gaussian and the YAMLs.

Flax modules of ``harl_tpu.models`` are initialised, their parameters are
perturbed (so no output is trivially zero) and copied into the port's
modules through ``harl_tpu_torch.utils.convert``; both sides then see the
same observations and, for the squashed Gaussian, the same normal draw.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harl_tpu.models.mlp import PlainMLP as JPlainMLP
from harl_tpu.models.policies import DeterministicPolicy as JDeterministic
from harl_tpu.models.policies import SquashedGaussianPolicy as JSquashed
from harl_tpu.models.values import ContinuousQNet as JQNet
from harl_tpu.ops import distributions as jdist
from harl_tpu.utils.config_tools import get_defaults_yaml_args as jdefaults
from harl_tpu_torch.models.mlp import PlainMLP
from harl_tpu_torch.models.policies import DeterministicPolicy, SquashedGaussianPolicy
from harl_tpu_torch.models.values import ContinuousQNet
from harl_tpu_torch.ops import distributions as tdist
from harl_tpu_torch.utils import convert
from harl_tpu_torch.utils.config_tools import get_defaults_yaml_args

# float32 forward passes of two or three small layers: the same products,
# summed in another order
RTOL = ATOL = 1e-5
OBS_DIM, ACT_DIM, HIDDEN, ROWS = 12, 3, (16, 16), 9


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _perturbed(params, seed):
    """numpy copy of a flax tree with every leaf moved by N(0, 0.3²)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.3 * rng.normal(size=x.shape)).astype(np.float32), params)


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("final", ["identity", "tanh"])
def test_plain_mlp_matches_flax(final):
    x = _x(0, ROWS, OBS_DIM)
    jnet = JPlainMLP((16, 16, 5), "relu", final_activation_func=final)
    params = _perturbed(jnet.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    tnet = PlainMLP(OBS_DIM, (16, 16, 5), "relu", final, device="cpu")
    tnet.load_state_dict(convert.plain_mlp_state_dict(params))
    _close(tnet(torch.from_numpy(x)).detach(), jnet.apply(params, jnp.asarray(x)))


def test_squashed_gaussian_policy_matches_flax():
    x = _x(2, ROWS, OBS_DIM)
    jpol = JSquashed(act_dim=ACT_DIM, hidden_sizes=HIDDEN)
    params = _perturbed(jpol.init(jax.random.PRNGKey(1), jnp.asarray(x)), 3)
    tpol = SquashedGaussianPolicy(OBS_DIM, ACT_DIM, HIDDEN, device="cpu")
    tpol.load_state_dict(convert.squashed_policy_state_dict(params))
    jmu, jls = jpol.apply(params, jnp.asarray(x))
    tmu, tls = tpol(torch.from_numpy(x))
    _close(tmu.detach(), jmu)
    _close(tls.detach(), jls)


def test_deterministic_policy_matches_flax():
    """Asymmetric bounds, so the affine rescale is exercised."""
    low, high = (-1.0, -2.0, 0.0), (1.0, 0.5, 3.0)
    x = _x(4, ROWS, OBS_DIM)
    jpol = JDeterministic(low=low, high=high, hidden_sizes=HIDDEN)
    params = _perturbed(jpol.init(jax.random.PRNGKey(2), jnp.asarray(x)), 5)
    tpol = DeterministicPolicy(OBS_DIM, low, high, HIDDEN, device="cpu")
    tpol.load_state_dict(convert.deterministic_policy_state_dict(params))
    _close(tpol(torch.from_numpy(x)).detach(), jpol.apply(params, jnp.asarray(x)))
    assert set(tpol.state_dict()) == {f"pi.fc.{i}.{k}" for i in range(3)
                                      for k in ("weight", "bias")}


def test_q_net_and_twins_match_flax():
    s, a = _x(6, ROWS, 7), _x(7, ROWS, 2 * ACT_DIM)
    jq = JQNet(hidden_sizes=HIDDEN)
    twins = tuple(_perturbed(jq.init(jax.random.PRNGKey(k), jnp.asarray(s), jnp.asarray(a)),
                             10 + k) for k in range(2))
    nets = torch.nn.ModuleList(ContinuousQNet(7, 2 * ACT_DIM, HIDDEN, device="cpu")
                               for _ in range(2))
    nets.load_state_dict(convert.q_nets_state_dict(twins))
    for net, p in zip(nets, twins):
        _close(net(torch.from_numpy(s), torch.from_numpy(a)).detach(),
               jq.apply(p, jnp.asarray(s), jnp.asarray(a)))


@pytest.mark.parametrize("case", ["sample", "clipped", "deterministic"])
def test_squashed_gaussian_sample_matches_jax(case):
    """The same normal: action and log-prob, with log-std inside [−5, 2],
    beyond both ends of it (the JAX package's −5 floor), and the mode."""
    mu = 1.5 * _x(8, ROWS, ACT_DIM)
    log_std = _x(9, ROWS, ACT_DIM) - 1.0
    if case == "clipped":
        log_std = log_std * 8.0          # many below −5, some above 2
        assert (log_std < -5).any() and (log_std > 2).any()
    key = jax.random.PRNGKey(3)
    eps = np.array(jax.random.normal(key, mu.shape))
    det = case == "deterministic"
    js = jdist.squashed_gaussian_sample(key, jnp.asarray(mu), jnp.asarray(log_std), 0.4,
                                        deterministic=det)
    ts = tdist.squashed_gaussian_sample(torch.from_numpy(mu), torch.from_numpy(log_std),
                                        None if det else torch.from_numpy(eps), 0.4,
                                        deterministic=det)
    _close(ts.action, js.action)
    _close(ts.log_prob, js.log_prob, rtol=1e-5, atol=1e-4)   # sums of terms up to ~30
    assert tuple(ts.log_prob.shape) == (ROWS, 1)


def test_plain_mlp_init_statistics():
    """flax Dense's default init — LeCun normal truncated at 2σ, zero bias —
    in statistics, not values: the same std and bound as a flax layer."""
    gen = torch.Generator().manual_seed(0)
    tnet = PlainMLP(256, (256, 1), device="cpu", generator=gen)
    w = tnet.fc[0].weight.detach().numpy()
    jw = np.asarray(JPlainMLP((256, 1)).init(jax.random.PRNGKey(0), jnp.zeros((1, 256)))
                    ["params"]["fc0"]["kernel"])
    assert abs(w.std() - jw.std()) < 0.02 * jw.std()
    assert abs(w.std() - 1 / 16) < 0.02 / 16        # variance 1/fan_in
    bound = 2.0 / 16 / 0.87962566103423978          # ±2σ of the untruncated normal
    assert np.abs(w).max() <= bound and np.abs(jw).max() <= bound * (1 + 1e-6)
    assert np.abs(w).max() > 0.95 * bound
    assert float(tnet.fc[1].bias.detach().abs().sum()) == 0.0


@pytest.mark.parametrize("algo", ["hasac", "haddpg", "hatd3", "maddpg", "matd3", "had3qn"])
def test_off_policy_yaml_copies_match(algo):
    port, _ = get_defaults_yaml_args(algo, "mamujoco_jax")
    ref, _ = jdefaults(algo, "mamujoco_jax")
    for section in ("train", "model", "algo"):
        assert port[section] == ref[section], section
