"""Port parity: the off-policy replay buffer (``buffers/off_policy.py``).

Steps of several threads with episode ends go into a ring that wraps; the
end flags and n-step samples from the same injected starts must equal the
JAX buffer's exactly: rows, rewards, γⁿ, dones and terms.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harl_tpu.buffers import off_policy as jbuf
from harl_tpu_torch.buffers import off_policy as tbuf

S, B, DS, OBS, ACT = 40, 4, 3, (5, 2), (2, 3)
GAMMA = 0.99


def _steps(n_steps, seed):
    """One dict of numpy arrays per vectorised step: random floats, dones
    with probability 0.2 and a truncation (done without term) now and then."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    out = []
    for _ in range(n_steps):
        dones = (rng.random((B, 1)) < 0.2).astype(np.float32)
        terms = dones * (rng.random((B, 1)) < 0.7)
        out.append(dict(
            share_obs=f(B, DS), next_share_obs=f(B, DS), rewards=f(B, 1),
            dones=dones, terms=terms.astype(np.float32),
            obs=[f(B, d) for d in OBS], next_obs=[f(B, d) for d in OBS],
            actions=[f(B, d) for d in ACT],
            valid_transitions=[(rng.random((B, 1)) < 0.9).astype(np.float32) for _ in OBS]))
    return out


def _fill(n_steps, seed=0):
    jb = jbuf.init_buffer(S, DS, list(OBS), list(ACT))
    tb = tbuf.ReplayBuffer(S, DS, OBS, ACT, device="cpu")
    for step in _steps(n_steps, seed):
        jb = jbuf.insert(jb, {k: tuple(jnp.asarray(x) for x in v) if isinstance(v, list)
                              else jnp.asarray(v) for k, v in step.items()})
        tb.insert({k: [torch.from_numpy(x) for x in v] if isinstance(v, list)
                   else torch.from_numpy(v) for k, v in step.items()})
    return jb, tb


def _equal(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("n_steps", [3, 10, 13])   # part full, full, wrapped
def test_insert_and_end_flag_match_jax(n_steps):
    jb, tb = _fill(n_steps)
    assert (tb.idx, tb.cur_size) == (int(jb.idx), int(jb.cur_size))
    for name in ("share_obs", "next_share_obs", "rewards", "dones", "terms"):
        _equal(getattr(tb, name), getattr(jb, name))
    for name in ("obs", "next_obs", "actions", "valid_transitions"):
        for t, j in zip(getattr(tb, name), getattr(jb, name)):
            _equal(t, j)
    _equal(tb.end_flag(B), jbuf._end_flag(jb, B))


@pytest.mark.parametrize("n_step", [1, 5])
@pytest.mark.parametrize("n_steps", [7, 13])
def test_sample_matches_jax(n_step, n_steps):
    jb, tb = _fill(n_steps, seed=n_step)
    start = np.random.default_rng(1).integers(0, tb.cur_size, 64)
    js = jbuf.sample(jb, None, 64, n_step, GAMMA, B, start=jnp.asarray(start))
    ts = tb.sample(64, n_step, GAMMA, B, start=torch.from_numpy(start))
    for name in ("share_obs", "rewards", "dones", "terms", "next_share_obs", "gamma"):
        _equal(getattr(ts, name), getattr(js, name))
    for name in ("obs", "actions", "valid_transitions", "next_obs"):
        for t, j in zip(getattr(ts, name), getattr(js, name)):
            _equal(t, j)
    # the walk did cross episode ends and thread heads
    if n_step > 1:
        assert len(np.unique(ts.gamma.numpy())) > 1


def test_sample_draws_starts_from_the_noise_source():
    _, tb = _fill(5)

    class Starts:
        def indices(self, n, high):
            assert (n, high) == (8, tb.cur_size)
            return torch.arange(n)

    ts = tb.sample(8, 3, GAMMA, B, noise=Starts())
    _equal(ts.share_obs, tb.share_obs[:8])


def test_fp_layout_raises():
    """The FP layout, refused before, runs (kept under its old name): its
    env-level fields carry an agent axis, and a sample's are agent-major
    (the parity against JAX is in test_torch_fp_off_policy.py)."""
    tb = tbuf.ReplayBufferFP(S, 2, DS, OBS, ACT, device="cpu")
    assert tuple(tb.share_obs.shape) == (S, 2, DS) and tuple(tb.dones.shape) == (S, 2, 1)
    for step in _steps(3, 0):
        step = {k: [torch.from_numpy(x) for x in v] if isinstance(v, list)
                else torch.from_numpy(v) for k, v in step.items()}
        for k in ("share_obs", "next_share_obs", "rewards", "dones", "terms"):
            step[k] = torch.stack([step[k], -step[k]], dim=1)
        tb.insert(step)
    ts = tb.sample(8, 2, GAMMA, B, start=torch.arange(8))
    assert tuple(ts.share_obs.shape) == (16, DS) and tuple(ts.gamma.shape) == (16, 1)
    _equal(ts.share_obs[8:], -ts.share_obs[:8])
