"""The port's real-binary adapters (SMAC, SMACv2, Bi-DexterousHands, and the
gfootball and LAG shells) through the upstream-faithful stub packages of
``tests/stubs/``, as ``tests/test_binary_adapters.py`` drives the JAX
package's; the env routing of ``backend`` ``native`` and ``auto``
(``tests/test_host_envs.py:137-157``); and the refusals where a package is
missing. Each adapter is held against the JAX package's on the same stub."""
import os
import sys

import numpy as np
import pytest

from harl_tpu_torch.envs import is_host_env, make_env

_STUBS = os.path.join(os.path.dirname(__file__), "stubs")
_STUB_MODULES = ("smac", "smacv2", "bidexhands", "isaacgym")


@pytest.fixture
def stubbed(monkeypatch):
    """Put tests/stubs on sys.path and evict any cached real or stub modules
    before and after, so other tests never see the fakes."""
    def purge():
        for name in list(sys.modules):
            if name.split(".")[0] in _STUB_MODULES:
                del sys.modules[name]

    purge()
    monkeypatch.syspath_prepend(_STUBS)
    yield
    purge()


def _same_steps(env, jenv, actions, steps):
    for a, b in zip(env.reset(), jenv.reset()):
        np.testing.assert_array_equal(a, b)
    out = None
    for _ in range(steps):
        out, jout = env.step(actions), jenv.step(actions)
        for a, b in zip(out, jout):
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b
    return out


def test_smac_adapter_protocol_and_seed_rebuild(stubbed):
    from smac.env import StarCraft2Env

    from harl_tpu.envs.smac.smac_env import make_smac as jmake_smac
    from harl_tpu_torch.envs.smac.smac_env import make_smac

    StarCraft2Env.constructed.clear()
    env = make_smac({"map_name": "3m", "seed": 11})
    assert StarCraft2Env.constructed == [("3m", 11)]
    # upstream seed() takes no argument: the adapter's seed rebuilds the env
    with pytest.raises(TypeError):
        env.env.seed(7)
    env.seed(7)
    assert StarCraft2Env.constructed[-1] == ("3m", 7) and env.env.seed() == 7
    jenv = jmake_smac({"map_name": "3m", "seed": 7})
    acts = np.ones((3, 1), np.int64)
    obs, state, rew, dones, infos, avail = _same_steps(env, jenv, acts, 4)
    assert obs.shape == (3, 8) and state.shape == (3, 12) and avail.shape == (3, 9)
    assert rew[0, 0] == 1.5 and not dones.any() and "bad_transition" not in infos[0]
    obs, state, rew, dones, infos, avail = env.step(acts)
    # an episode-limit end is a truncation
    assert dones.all() and infos[0]["bad_transition"] and infos[2]["bad_transition"]
    env.close()
    assert env.env._closed


def test_smac_adapter_hostvec_per_rank_seeds(stubbed):
    from smac.env import StarCraft2Env

    from harl_tpu_torch.envs.host import HostVecEnv
    from harl_tpu_torch.envs.smac.smac_env import make_smac

    StarCraft2Env.constructed.clear()
    vec = HostVecEnv([lambda: make_smac({"map_name": "3m"})] * 2, seed=5)
    # each env built without a seed, then rebuilt with seed + rank·1000
    assert [s for _, s in StarCraft2Env.constructed][-2:] == [5, 1005]
    obs, share, avail = vec.reset()
    assert obs.shape == (2, 3, 8) and share.shape == (2, 3, 12) and avail.shape == (2, 3, 9)
    out = vec.step(np.ones((2, 3, 1), np.int64))
    assert out["obs"].shape == (2, 3, 8) and out["rewards"].shape == (2, 3, 1)
    assert out["dones"].shape == (2, 3)
    vec.close()


def test_smacv2_adapter_full_wrapper_kwargs(stubbed):
    from smacv2.env.starcraft2.wrapper import StarCraftCapabilityEnvWrapper

    from harl_tpu.envs.smacv2.smacv2_env import make_smacv2 as jmake_smacv2
    from harl_tpu_torch.envs.smacv2.smacv2_env import make_smacv2

    StarCraftCapabilityEnvWrapper.constructed.clear()
    env = make_smacv2({"map_name": "protoss_5_vs_5", "seed": 3})
    # the stub rejects a bare capability subtree: the adapter passes the
    # reference's full wrapper kwargs
    assert StarCraftCapabilityEnvWrapper.constructed[-1] == ("10gen_protoss", 3, 5)
    env.seed(9)
    assert StarCraftCapabilityEnvWrapper.constructed[-1] == ("10gen_protoss", 9, 5)
    jenv = jmake_smacv2({"map_name": "protoss_5_vs_5", "seed": 9})
    obs, state, rew, dones, infos, avail = _same_steps(env, jenv, np.zeros((5, 1), np.int64), 5)
    assert obs.shape == (5, 10) and state.shape == (5, 16)
    assert dones.all() and infos[0]["bad_transition"]
    env.close()
    assert env.env._closed


def test_smacv2_map_configs_carry_full_wrapper_kwargs():
    from harl_tpu.envs.smacv2.smacv2_env import load_map_config as jload
    from harl_tpu_torch.envs.smacv2.smacv2_env import load_map_config

    for race in ("protoss", "terran", "zerg"):
        for pair in ("5_vs_5", "10_vs_10", "10_vs_11", "20_vs_20", "20_vs_23"):
            cfg = load_map_config(f"{race}_{pair}")
            assert cfg == jload(f"{race}_{pair}")
            assert cfg["map_name"] == f"10gen_{race}"
            assert "capability_config" in cfg and "n_units" not in cfg


def test_dexhands_adapter_vec_protocol(stubbed):
    from harl_tpu_torch.envs.dexhands.dexhands_env import make_dexhands

    env = make_dexhands({"task": "ShadowHandOver", "n_threads": 4, "hands_episode_length": 75})
    assert env.is_vec and env.n_agents == 2 and env.n_envs == 4
    env.seed(1)  # a no-op, must not raise
    obs, share, _ = env.reset()
    assert obs.shape == (4, 2, 24) and share.shape == (4, 2, 48)
    obs, state, rew, done, infos, avail = env.step(np.zeros((4, 2, 20), np.float32))
    # env-major actions go to the sim agent-major
    assert env.env.step_actions == [(2, 4, 20)]
    assert obs.shape == (4, 2, 24) and rew.shape == (4, 2, 1)
    assert done.shape == (4, 2) and not done.any()
    env.close()


def test_registry_routes_native_backend_to_adapters(stubbed):
    from harl_tpu_torch.envs.dexhands.dexhands_env import DexHandsEnv
    from harl_tpu_torch.envs.smac.smac_env import SMACEnv
    from harl_tpu_torch.envs.smacv2.smacv2_env import SMACv2Env

    assert isinstance(make_env("smac", {"map_name": "3m", "backend": "native"}), SMACEnv)
    assert isinstance(make_env("smacv2", {"map_name": "terran_5_vs_5", "backend": "native"}),
                      SMACv2Env)
    # with the package importable, auto takes the real game too
    assert isinstance(make_env("smac", {"map_name": "3m"}), SMACEnv)
    assert is_host_env("smac", {}) and is_host_env("smacv2", {"backend": "auto"})
    assert not is_host_env("smac", {"backend": "jax"})
    assert isinstance(make_env("dexhands", {"task": "ShadowHandOver", "n_threads": 2,
                                            "backend": "native"}), DexHandsEnv)


def test_adapters_fail_informatively_and_auto_falls_back():
    """Without the StarCraft II or IsaacGym packages (this host), backend
    native raises the adapter's ImportError and auto runs the tensor envs
    (tests/test_host_envs.py:137-157); gfootball and LAG name their
    packages."""
    with pytest.raises(ImportError, match="StarCraft II"):
        make_env("smac", {"map_name": "3m", "backend": "native"}, device="cpu")
    with pytest.raises(ImportError, match="StarCraft II"):
        make_env("smacv2", {"map_name": "protoss_5_vs_5", "backend": "native"}, device="cpu")
    with pytest.raises(ImportError, match="IsaacGym"):
        make_env("dexhands", {"task": "ShadowHandOver", "n_threads": 2, "backend": "native"},
                 device="cpu")
    with pytest.raises(ImportError, match="gfootball"):
        make_env("football", {}, device="cpu")
    with pytest.raises(ImportError, match="CloseAirCombat"):
        make_env("lag", {"task": "2v2/NoWeapon/Selfplay"}, device="cpu")
    env = make_env("smac", {"map_name": "3m"}, device="cpu")
    assert env.n_agents == 3 and getattr(env, "is_jax", True) is not False
    assert make_env("smacv2", {"map_name": "protoss_5_vs_5"}, device="cpu").n_agents == 5
    assert make_env("dexhands", {"task": "ShadowHandOver"}, device="cpu").n_agents == 2
    assert not any(is_host_env(name, {}) for name in ("smac", "smacv2", "dexhands", "mpe"))
    assert all(is_host_env(name, {}) for name in ("mamujoco", "gym", "football", "lag"))


HOST_MODULES = ("envs.host", "envs.gym.gym_env", "envs.mamujoco.mamujoco",
                "envs.mamujoco.native_vec", "native.build", "envs.smac.smac_env",
                "envs.smacv2.smacv2_env", "envs.football.football_env", "envs.lag.lag_env",
                "envs.dexhands.dexhands_env")


def test_host_modules_import_without_jax():
    """Every host-env module imports with JAX, flax, optax and harl_tpu made
    unimportable (``tests/test_torch_package.py``'s walk), and imports none
    of the adapters' optional packages."""
    from tests.test_torch_package import _import_walk

    names = _import_walk()
    for name in HOST_MODULES:
        assert f"harl_tpu_torch.{name}" in names, names


def test_runners_train_on_the_stub_smac_adapter(stubbed):
    """Both runners train on the SMAC adapter (Discrete heads, availability
    rows, a state tiled per agent, truncations at the stub's 5 steps). The
    EP state is agent 0's row, as the reference's EP runners store it; the
    JAX package's host path keeps the agent axis and fails on the GAE's
    shapes (ROADMAP Queue C)."""
    import copy

    from harl_tpu.runners.on_policy import OnPolicyRunner as JRunner
    from harl_tpu_torch.runners.off_policy import OffPolicyRunner
    from harl_tpu_torch.runners.on_policy import OnPolicyRunner
    from harl_tpu_torch.utils.config_tools import get_defaults_yaml_args

    env_args = {"map_name": "3m", "backend": "native"}
    algo_args, _ = get_defaults_yaml_args("happo", "smac")
    algo_args["train"].update(n_rollout_threads=2, episode_length=6, num_env_steps=12)
    algo_args["model"]["hidden_sizes"] = [8, 8]
    algo_args["eval"]["use_eval"] = False
    args = {"algo": "happo", "env": "smac"}
    with pytest.raises(ValueError, match="broadcasting"):
        JRunner(args, copy.deepcopy(algo_args), dict(env_args)).run(seed=1)
    runner = OnPolicyRunner(args, algo_args, env_args, device="cpu")
    state, history = runner.run(seed=1)
    assert runner.host_mode and state.carry.share_obs.shape == (2, 12)
    assert state.carry.avail.shape == (2, 3, 9) and np.isfinite(history[-1]["value_loss"])
    assert history[-1]["mean_episode_return"] == 7.5          # 5 steps of 1.5

    algo_args, _ = get_defaults_yaml_args("hasac", "smac")
    algo_args["train"].update(n_rollout_threads=2, warmup_steps=4, train_interval=3,
                              num_env_steps=6)
    algo_args["algo"].update(batch_size=4, buffer_size=50)
    algo_args["model"]["hidden_sizes"] = [8, 8]
    algo_args["eval"]["use_eval"] = False
    runner = OffPolicyRunner({"algo": "hasac", "env": "smac"}, algo_args, env_args,
                             device="cpu")
    state, history = runner.run(seed=1)
    buf = state.buffer
    assert buf.cur_size == 10 and buf.share_obs.shape[1] == 12
    assert buf.available_actions[0].shape == (50, 9) and float(buf.dones.sum()) == 2
    assert float(buf.terms.sum()) == 0                         # the limit is a truncation
    assert np.isfinite(history[-1]["critic_loss"])
