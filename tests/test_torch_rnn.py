"""Port parity: the masked GRU stack against ``harl_tpu.models.rnn.GRUStack``.

The flax module is initialised, its parameters perturbed and copied into the
port's module (the fused (in, 3H) / (H, 3H) layout carries over without a
transpose); both sides then see the same inputs, hidden states and masks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harl_tpu.models.rnn import GRUStack as JGRU
from harl_tpu_torch.models.rnn import GRUStack

# float32 matmuls of width 16 summed in another order, carried through the
# recurrence for 70 steps
RTOL, ATOL = 1e-5, 1e-6
T, N, D, H = 70, 6, 10, 16


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _pair(recurrent_n, seed=0):
    rng = np.random.default_rng(seed)
    jm = JGRU(hidden_size=H, recurrent_n=recurrent_n)
    x = rng.normal(size=(T, N, D)).astype(np.float32)
    h0 = rng.normal(size=(N, recurrent_n, H)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x[0]), jnp.asarray(h0),
                     jnp.ones((N, 1)))
    params = jax.tree.map(
        lambda p: (np.asarray(p) + 0.2 * rng.normal(size=p.shape)).astype(np.float32), params)
    tm = GRUStack(D, H, recurrent_n, device="cpu")
    p = params["params"]
    sd = {k: torch.from_numpy(np.array(v)) for k, v in p.items() if k != "norm"}
    sd["norm.weight"] = torch.from_numpy(np.array(p["norm"]["scale"]))
    sd["norm.bias"] = torch.from_numpy(np.array(p["norm"]["bias"]))
    tm.load_state_dict(sd)
    # masks that zero mid-sequence: env-wise episode boundaries, some at t=0
    masks = (rng.uniform(size=(T, N, 1)) > 0.1).astype(np.float32)
    masks[0, 0] = 0.0
    return jm, params, tm, x, h0, masks


@pytest.mark.parametrize("recurrent_n", [1, 2])
def test_sequence_mode_matches_flax(recurrent_n):
    jm, params, tm, x, h0, masks = _pair(recurrent_n)
    jout, jh = jm.apply(params, jnp.asarray(x), jnp.asarray(h0), jnp.asarray(masks), seq=True)
    with torch.no_grad():
        tout, th = tm(torch.from_numpy(x), torch.from_numpy(h0), torch.from_numpy(masks),
                      seq=True)
    assert tuple(tout.shape) == (T, N, H) and tuple(th.shape) == (N, recurrent_n, H)
    _close(tout, jout)
    _close(th, jh)


@pytest.mark.parametrize("recurrent_n", [1, 2])
def test_step_mode_matches_flax_and_sequence_mode(recurrent_n):
    """70 single steps equal flax's single steps and the port's own
    sequence mode."""
    jm, params, tm, x, h0, masks = _pair(recurrent_n, seed=1)
    jstep = jax.jit(lambda xt, h, m: jm.apply(params, xt, h, m))
    jh, th = jnp.asarray(h0), torch.from_numpy(h0)
    outs = []
    with torch.no_grad():
        for t in range(T):
            jout, jh = jstep(jnp.asarray(x[t]), jh, jnp.asarray(masks[t]))
            tout, th = tm(torch.from_numpy(x[t]), th, torch.from_numpy(masks[t]))
            _close(tout, jout)
            _close(th, jh)
            outs.append(tout)
        seq_out, seq_h = tm(torch.from_numpy(x), torch.from_numpy(h0), torch.from_numpy(masks),
                            seq=True)
    np.testing.assert_array_equal(torch.stack(outs).numpy(), seq_out.numpy())
    np.testing.assert_array_equal(th.numpy(), seq_h.numpy())


def test_mask_resets_the_hidden_state():
    """A zero mask makes the step start from zeros, whatever came before."""
    _, _, tm, x, h0, _ = _pair(1, seed=2)
    zero = torch.zeros((N, 1))
    with torch.no_grad():
        a, _ = tm(torch.from_numpy(x[0]), torch.from_numpy(h0), zero)
        b, _ = tm(torch.from_numpy(x[0]), torch.zeros((N, 1, H)), torch.ones((N, 1)))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert tm.norm.eps == 1e-6


def test_fresh_init_statistics():
    """Orthogonal weights and zero biases, as the JAX module initialises."""
    tm = GRUStack(H, H, 1, device="cpu", generator=torch.Generator().manual_seed(0))
    w = tm.wh0.detach()
    _close(w @ w.T, np.eye(H), atol=1e-5)
    assert float(tm.bi0.detach().abs().sum() + tm.bh0.detach().abs().sum()) == 0.0
