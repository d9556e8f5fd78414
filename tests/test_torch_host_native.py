"""Port parity of the native vec-MuJoCo engine: ``harl_tpu_torch/native``
(its own copy of ``vec_mujoco.cc``, built into ``harl_tpu_torch/_build/``)
and ``envs/mamujoco/native_vec.py``, against ``harl_tpu``'s engine and env
in the same process (two libraries, two ctypes handles), bitwise over 50
steps of each task with an auto-reset; and the protocol checks of
``tests/test_native_vec.py``."""
import numpy as np
import pytest

from harl_tpu.envs.mamujoco.native_vec import NativeMAMuJoCoVec as JNativeVec
from harl_tpu.native import build as jbuild
from harl_tpu_torch.envs import make_env
from harl_tpu_torch.envs.mamujoco.native_vec import RULES, NativeMAMuJoCoVec
from harl_tpu_torch.native import build

TASKS = [("HalfCheetah-v2", "6x1"), ("Walker2d-v2", "2x3"), ("Hopper-v2", "3x1"),
         ("Ant-v2", "4x2"), ("Humanoid-v2", "17x1")]
N_ENVS, STEPS, LIMIT = 3, 50, 20


def _pair(scenario, conf, n=N_ENVS, **kw):
    args = {"scenario": scenario, "agent_conf": conf, "episode_limit": LIMIT, **kw}
    env, jenv = NativeMAMuJoCoVec(dict(args)), JNativeVec(dict(args))
    env.ensure_envs(n, seed=0)
    jenv.ensure_envs(n, seed=0)
    return env, jenv


def test_the_port_builds_its_own_library():
    lib = build.load()
    path = build.build()
    assert path.parent == build.BUILD_DIR and path.parent.name == "_build"
    assert path.parent.parent.name == "harl_tpu_torch" and path.exists()
    assert build.SRC.parent.parent.name == "harl_tpu_torch"
    # another file and another handle than the JAX package's engine
    jlib = jbuild.load()
    assert path.resolve() != jbuild.build().resolve() and lib is not jlib
    assert lib.vmj_create is not jlib.vmj_create
    assert sorted(RULES) == ["Ant", "HalfCheetah", "Hopper", "Humanoid", "Walker2d"]


@pytest.mark.parametrize("scenario,conf", TASKS)
def test_native_engine_matches_jax(scenario, conf):
    env, jenv = _pair(scenario, conf)
    assert (env.nq, env.nv, env.nu, env.dt) == (jenv.nq, jenv.nv, jenv.nu, jenv.dt)
    assert env._act_slices == jenv._act_slices and env.state_dim == jenv.state_dim
    for a, b in zip(env.reset(), jenv.reset()):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(4)
    width = max(sp.dim for sp in env.action_space)
    ended = 0
    for _ in range(STEPS):
        act = rng.uniform(-1, 1, (N_ENVS, env.n_agents, width))
        out, jout = env.step(act), jenv.step(act)
        assert set(out) == set(jout) and out["infos"] == jout["infos"]
        for k, v in out.items():
            if isinstance(v, np.ndarray):
                assert v.dtype == jout[k].dtype, k
                np.testing.assert_array_equal(v, jout[k], err_msg=k)
        ended += int(out["dones"][:, 0].sum())
    assert ended >= N_ENVS           # at least one auto-reset an env
    np.testing.assert_array_equal(env._qpos, jenv._qpos)
    np.testing.assert_array_equal(env.steps, jenv.steps)
    env.close()
    jenv.close()


def test_protocol_truncation_and_termination():
    env = make_env("mamujoco", {"scenario": "HalfCheetah-v2", "agent_conf": "6x1",
                                "episode_limit": 5, "backend": "native"}, device="cpu")
    assert isinstance(env, NativeMAMuJoCoVec) and env.is_vectorized and not env.is_jax
    with pytest.raises(RuntimeError, match="ensure_envs"):
        env.reset()
    env.ensure_envs(2)
    obs, share, avail = env.reset()
    assert obs.shape == (2, 6, 17 + 6) and share.shape == (2, 17) and avail is None
    np.testing.assert_allclose(obs.mean(axis=2), 0.0, atol=1e-6)
    for _ in range(5):
        res = env.step(np.zeros((2, 6, 1)))
    # the limit: a truncation, auto-reset, the terminal obs kept apart
    assert res["dones"].all() and all(info[0]["bad_transition"] for info in res["infos"])
    assert (env.steps == 0).all() and not np.array_equal(res["obs"], res["final_obs"])
    assert np.all(res["rewards"] == res["rewards"][:, :1])
    env.close()
    hopper = NativeMAMuJoCoVec({"scenario": "Hopper-v2", "agent_conf": "3x1"})
    hopper.ensure_envs(2)
    hopper.reset()
    for _ in range(400):
        res = hopper.step(np.zeros((2, 3, 1)))
        if res["dones"].any():
            idx = np.nonzero(res["dones"][:, 0])[0][0]
            assert not res["infos"][idx][0]["bad_transition"]   # a fall is a real done
            break
    else:
        pytest.fail("a zero-torque hopper falls")
    hopper.close()
    with pytest.raises(ValueError, match="unsupported scenario"):
        NativeMAMuJoCoVec({"scenario": "Swimmer-v2"})
    # backend auto falls back to gymnasium's task where the engine has none
    from harl_tpu_torch.envs.mamujoco.mamujoco import MAMuJoCoEnv

    assert isinstance(make_env("mamujoco", {"scenario": "Swimmer-v2", "agent_conf": "2x1"},
                               device="cpu"), MAMuJoCoEnv)
