"""Port parity: returns, advantage normalisation and ValueNorm.

The same numpy inputs go through ``harl_tpu.ops`` (the lax.scan form and the
Pallas kernels in interpret mode) and through ``harl_tpu_torch.ops`` on the
CPU, where the wrappers take the plain versions of the CUDA kernels.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harl_tpu.ops import returns as jret
from harl_tpu.ops import value_norm as jvn
from harl_tpu.ops.pallas_gae import discounted_returns_pallas, gae_pallas
from harl_tpu_torch.ops import gae_kernels
from harl_tpu_torch.ops import returns as tret
from harl_tpu_torch.ops import value_norm as tvn

# float32 recursions over T=9 steps; the two sides round in another order
RTOL = ATOL = 1e-5
GAMMA, LAM = 0.99, 0.95


def _problem(seed, T, trailing):
    rng = np.random.default_rng(seed)
    f = np.float32
    rewards = rng.normal(size=(T,) + trailing).astype(f)
    values = rng.normal(size=(T + 1,) + trailing).astype(f)
    masks = (rng.uniform(size=(T + 1,) + trailing) > 0.15).astype(f)
    bad = (rng.uniform(size=(T + 1,) + trailing) > 0.1).astype(f)
    return rewards, values, masks, bad


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


TRAILING = [(7, 1), (4, 3, 1), (130, 1)]


@pytest.mark.parametrize("trailing", TRAILING)
@pytest.mark.parametrize("with_bad", [True, False])
def test_gae_matches_scan_and_pallas(trailing, with_bad):
    r, v, m, b = _problem(0, 9, trailing)
    b = b if with_bad else None
    jb = None if b is None else jnp.asarray(b)
    scan = jret.compute_gae(jnp.asarray(r), jnp.asarray(v), jnp.asarray(m), jb, GAMMA, LAM)
    pallas = gae_pallas(jnp.asarray(r), jnp.asarray(v), jnp.asarray(m), jb, GAMMA, LAM,
                        interpret=True)
    tb = None if b is None else torch.from_numpy(b)
    out = tret.compute_gae(torch.from_numpy(r), torch.from_numpy(v), torch.from_numpy(m),
                           tb, GAMMA, LAM)
    assert out.shape == r.shape
    _close(out, scan)
    _close(out, pallas)


@pytest.mark.parametrize("trailing", TRAILING)
@pytest.mark.parametrize("with_bad", [True, False])
def test_discounted_returns_match_scan_and_pallas(trailing, with_bad):
    r, v, m, b = _problem(1, 9, trailing)
    b = b if with_bad else None
    jb = None if b is None else jnp.asarray(b)
    nv = v[-1]
    scan = jret.compute_discounted_returns(jnp.asarray(r), jnp.asarray(v), jnp.asarray(m), jb,
                                           jnp.asarray(nv), GAMMA)
    pallas = discounted_returns_pallas(jnp.asarray(r), jnp.asarray(v), jnp.asarray(m), jb,
                                       jnp.asarray(nv), GAMMA, interpret=True)
    tb = None if b is None else torch.from_numpy(b)
    out = tret.compute_discounted_returns(torch.from_numpy(r), torch.from_numpy(v),
                                          torch.from_numpy(m), tb, torch.from_numpy(nv), GAMMA)
    _close(out, scan)
    _close(out, pallas)


def test_cpu_wrappers_leave_launch_counters_alone():
    r, v, m, b = (torch.from_numpy(x) for x in _problem(2, 5, (6, 1)))
    before = (gae_kernels.gae.launches, gae_kernels.discounted_returns.launches)
    gae_kernels.gae(r, v, m, b, GAMMA, LAM)
    gae_kernels.discounted_returns(r, v, m, b, v[-1].contiguous(), GAMMA)
    tret.compute_gae(r, v, m, None, GAMMA, LAM)
    assert (gae_kernels.gae.launches, gae_kernels.discounted_returns.launches) == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    r, v, m, b = (torch.from_numpy(x) for x in _problem(3, 4, (5, 1)))
    with pytest.raises(TypeError):
        gae_kernels.gae(r.double(), v, m, b, GAMMA, LAM)
    with pytest.raises(ValueError):
        gae_kernels.gae(r, v[:-1], m, b, GAMMA, LAM)
    with pytest.raises(ValueError):
        gae_kernels.gae(r, v, m, b.transpose(0, 1).contiguous().transpose(0, 1), GAMMA, LAM)
    with pytest.raises(ValueError):
        gae_kernels.discounted_returns(r, v, m, b, v[-1, :3].contiguous(), GAMMA)


def test_masked_mean_std_population_std():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(6, 5, 1)).astype(np.float32)
    mask = (rng.uniform(size=(6, 5, 1)) > 0.3).astype(np.float32)
    jm, js = jret.masked_mean_std(jnp.asarray(x), jnp.asarray(mask))
    tm, ts = tret.masked_mean_std(torch.from_numpy(x), torch.from_numpy(mask))
    _close(tm, jm)
    _close(ts, js)
    # ddof=0, like np.nanstd: an unbiased (ddof=1) std would differ by ~3% here
    sel = x[mask != 0]
    _close(ts, np.std(sel, ddof=0))
    assert abs(float(ts) - np.std(sel, ddof=1)) > 1e-3


def test_normalize_advantages_masked_applies_to_all_elements():
    rng = np.random.default_rng(5)
    adv = rng.normal(2.0, 3.0, size=(8, 4, 1)).astype(np.float32)
    active = (rng.uniform(size=(8, 4, 1)) > 0.25).astype(np.float32)
    j = jret.normalize_advantages_masked(jnp.asarray(adv), jnp.asarray(active))
    t = tret.normalize_advantages_masked(torch.from_numpy(adv), torch.from_numpy(active))
    _close(t, j)
    # inactive elements are normalised too, not zeroed
    assert np.all(t.numpy()[active == 0] != 0)


def test_value_norm_over_several_updates():
    rng = np.random.default_rng(6)
    js, ts = jvn.init_value_norm(1), tvn.init_value_norm(1, device="cpu")
    for k in range(5):
        x = rng.normal(3.0 * k, 2.0 + k, size=(16, 8, 1)).astype(np.float32)
        js = jvn.update_value_norm(js, jnp.asarray(x))
        ts = tvn.update_value_norm(ts, torch.from_numpy(x))
        for name in ("running_mean", "running_mean_sq", "debiasing_term"):
            _close(getattr(ts, name), getattr(js, name), rtol=1e-5, atol=1e-7)
        probe = rng.normal(size=(10, 1)).astype(np.float32)
        _close(tvn.normalize(ts, torch.from_numpy(probe)), jvn.normalize(js, jnp.asarray(probe)))
        _close(tvn.denormalize(ts, torch.from_numpy(probe)),
               jvn.denormalize(js, jnp.asarray(probe)))
