"""Port parity: coupled_half_cheetah (``envs/mamujoco_jax/coupled.py``)
against the JAX env.

The tendon force and one planar substep with an external root force are
held at rtol 1e-5 / atol 1e-6 from the same states (tendons slack, taut
and past the 3.5 limit); a reset from replayed draws and free env steps of
random actions at the planar tolerance (rtol 1e-4 / atol 2e-4), through
the truncation at ``episode_limit``, with the reference's observation
quirk (the second cheetah's absolute x in the state).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from harl_tpu.envs.mamujoco_jax import coupled as jco
from harl_tpu_torch.envs import make_env
from harl_tpu_torch.envs.mamujoco_jax import coupled as tco

from tests.torch_replay import reset_noise

KIN_RTOL, KIN_ATOL = 1e-5, 1e-6
RTOL, ATOL = 1e-4, 2e-4
X = 8


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def test_tendon_and_substep_with_root_force_match_jax():
    jenv = jco.make_coupled({})
    tenv = make_env("mamujoco_jax", {"scenario": "coupled_half_cheetah"}, device="cpu")
    assert isinstance(tenv, tco.CoupledHalfCheetah)
    assert (tenv.obs_dim, tenv.state_dim) == (jenv.obs_dim, jenv.state_dim) == (37, 35)
    rng = np.random.default_rng(0)
    qA = rng.uniform(-0.3, 0.3, (X, 9)).astype(np.float32)
    qB = rng.uniform(-0.3, 0.3, (X, 9)).astype(np.float32)
    qA[:, 0] += np.linspace(-4.0, 4.0, X, dtype=np.float32)    # slack … past 3.5
    jf = jax.vmap(jenv._tendon_force)(qA, qB)
    tf = tenv.tendon_force(torch.from_numpy(qA), torch.from_numpy(qB))
    _close(tf, jf, KIN_RTOL, KIN_ATOL)
    assert float(np.abs(np.asarray(jf)).max()) > 100.0          # a limit penalty acts
    qd = rng.normal(0.0, 1.0, (X, 9)).astype(np.float32)
    tau = rng.uniform(-1.0, 1.0, (X, 6)).astype(np.float32)
    jq, jqd = jax.jit(jax.vmap(lambda a, b, c, f: jenv.dyn._substep(a, b, c, root_force=f)))(
        qA, qd, tau, jf)
    tq, tqd = tenv.dyn.substep(*(torch.from_numpy(np.asarray(x)) for x in (qA, qd, tau)),
                               root_force=tf)
    _close(tq, jq, KIN_RTOL, KIN_ATOL)
    _close(tqd, jqd, KIN_RTOL, KIN_ATOL)


def test_reset_and_free_steps_match_jax():
    jenv = jco.make_coupled({"episode_limit": 6})
    tenv = make_env("mamujoco_jax", {"scenario": "coupled_half_cheetah", "episode_limit": 6},
                    device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(4), X)
    js, jts = jax.vmap(jenv.reset)(keys)
    ts, tts = tenv.reset(tuple(torch.from_numpy(np.array(x)) for x in reset_noise(keys, 18)))
    _close(ts.q, js.q, 1e-6, 1e-7)
    _close(tts.obs, jts.obs, 1e-5, 1e-5)
    jstep = jax.jit(jax.vmap(lambda s, a: jenv.step(s, a, None)))
    rng = np.random.default_rng(0)
    for step in range(8):
        a = rng.uniform(-1.0, 1.0, (X, 2, 6)).astype(np.float32)
        js, jts = jstep(js, jnp.asarray(a))
        ts, tts = tenv.step(ts, torch.from_numpy(a))
        for t, j in ((ts.q, js.q), (ts.qd, js.qd), (tts.obs, jts.obs),
                     (tts.share_obs, jts.share_obs), (tts.rewards, jts.rewards)):
            _close(t, j)
        np.testing.assert_array_equal(tts.dones.numpy(), np.asarray(jts.dones))
        np.testing.assert_array_equal(tts.bad_transition.numpy(), np.asarray(jts.bad_transition))
        assert bool(tts.bad_transition.all()) == (step + 1 >= 6)
