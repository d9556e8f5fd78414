"""Port parity: the Allegro (4-finger) and Meta layouts of the
Bi-DexterousHands catch family (``envs/dexhands_jax/handover.py``) against
the JAX env: each task resets from the JAX draws and runs 4 env steps of
random actions on both sides, at the tolerances of
``tests/test_torch_dexhands.py`` (states, observations and rewards at rtol
1e-4 / atol 1e-5; ``won``, dones and bad masks equal; the rotation angle at
atol 2e-3). MT4 draws one of four layouts per episode.
"""
import jax
import numpy as np
import pytest

from harl_tpu.envs.dexhands_jax import handover as jho
from harl_tpu_torch.envs import make_env
from harl_tpu_torch.envs.dexhands_jax import handover as tho

from tests.test_torch_dexhands import (KIN_ATOL, KIN_RTOL, ROT_ATOL, SHADOW_CATCH, STEPS, _close,
                                       _noise, free_steps, jax_fns)

OTHER_CATCH = tuple(t for t in jho.DEXHANDS_TASKS if t not in SHADOW_CATCH)


@pytest.mark.parametrize("task", OTHER_CATCH)
def test_allegro_and_meta_tasks_reset_and_step_like_jax(task):
    worst, ts, _, js = free_steps(task)
    print(f"{task}: worst element over {STEPS} steps {worst:.3f} of the tolerance")
    assert worst <= 1.0
    rot_t = tho.quat_angle(ts.obj_quat, ts.goal_quat).numpy()
    _close(rot_t, np.asarray(jho._quat_angle(js.obj_quat, js.goal_quat)), 0.0, ROT_ATOL)
    assert ts.theta.shape[-1] == (16 if task.startswith("Allegro") else 20)


def test_meta_mt4_draws_several_layouts():
    """MT4 draws a layout per episode: the envs' hands sit where their own
    layout puts them."""
    tenv = make_env("dexhands_jax", {"task": "ShadowHandMetaMT4"}, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(5), 16)
    ts, tts = tenv.reset(_noise(tenv, keys))
    js, jts = jax_fns("ShadowHandMetaMT4")[0](keys)
    np.testing.assert_array_equal(ts.layout.numpy(), np.asarray(js.layout))
    assert len(set(ts.layout.tolist())) >= 3
    _close(tts.obs, jts.obs, KIN_RTOL, KIN_ATOL)
