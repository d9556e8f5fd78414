"""The port's package boundary: no JAX, no ``harl_tpu``, CUDA by default."""
import math
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from harl_tpu_torch.algos.off_policy_actors import HASACActor
from harl_tpu_torch.ops import gae_kernels
from harl_tpu_torch.runners.off_policy import OffPolicyRunner
from harl_tpu_torch.runners.on_policy import OnPolicyRunner
from harl_tpu_torch.utils.config_tools import get_defaults_yaml_args

ROOT = Path(__file__).resolve().parent.parent
ARGS = {"algo": "happo", "env": "mamujoco_jax"}


def _small_configs():
    algo_args, env_args = get_defaults_yaml_args("happo", "mamujoco_jax")
    algo_args["train"].update(n_rollout_threads=4, episode_length=4)
    algo_args["model"].update(hidden_sizes=[8, 8])
    algo_args["algo"].update(ppo_epoch=1, critic_epoch=1)
    env_args.update(episode_limit=3)
    return algo_args, env_args


def _import_walk():
    """Import every module of the package in a fresh process with JAX, flax,
    optax and harl_tpu made unimportable; returns the module names."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "flax", "optax", "harl_tpu"):
            sys.modules[name] = None
        import harl_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(harl_tpu_torch.__path__,
                                                       "harl_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "harl_tpu")
                        and sys.modules[m] is not None)
        assert not loaded, loaded
        print(" ".join(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_imports_no_jax_and_no_harl_tpu():
    """Every module of the package imports with JAX, flax and optax made
    unimportable, and loads nothing of harl_tpu."""
    names = _import_walk()
    for name in ("runners.on_policy", "runners.common", "train", "logging.logger",
                 "utils.checkpoint", "utils.profiling", "utils.config_tools", "algos.hatrpo",
                 "envs.mamujoco_jax.ant", "envs.smaclite.smaclite", "buffers.off_policy",
                 "envs.mamujoco_jax.humanoid", "envs.dexhands_jax.handover",
                 "envs.dexhands_jax.manip"):
        assert f"harl_tpu_torch.{name}" in names, names
    assert len(names) >= 20


def test_off_policy_modules_import_without_jax():
    names = _import_walk()
    for name in ("buffers.off_policy", "algos.q_critics", "algos.off_policy_actors",
                 "runners.off_policy", "envs.mpe.mpe", "envs.mamujoco_jax.planar"):
        assert f"harl_tpu_torch.{name}" in names, names


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    algo_args, env_args = _small_configs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OnPolicyRunner(ARGS, algo_args, env_args)
    from harl_tpu_torch.envs import make_env

    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_env("mamujoco_jax", env_args)


def test_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a CUDA device is refused, not sent
    to the plain version."""
    r = torch.zeros((3, 2, 1), device="meta")
    v = torch.zeros((4, 2, 1), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        gae_kernels.gae(r, v, v, None, 0.99, 0.95)
    with pytest.raises(ValueError, match="cuda or cpu"):
        gae_kernels.discounted_returns(r, v, v, v, v[0], 0.99)


def test_cpu_path_runs_when_asked():
    algo_args, env_args = _small_configs()
    runner = OnPolicyRunner(ARGS, algo_args, env_args, device="cpu")
    state = runner.init_state(0)
    before = gae_kernels.gae.launches
    for _ in range(2):
        state, metrics = runner.train_iteration(state)
    assert gae_kernels.gae.launches == before
    assert tuple(metrics["actor_stats"].shape) == (6, 4)
    assert bool(torch.isfinite(metrics["actor_stats"]).all())
    assert math.isfinite(float(metrics["value_loss"]))
    assert float(metrics["episode_count"]) == 4.0   # one truncation per env
    assert state.carry.obs.device.type == "cpu"


def _with(algo_args, section, key, value):
    a = {k: dict(v) if isinstance(v, dict) else v for k, v in algo_args.items()}
    a[section][key] = value
    return a


def _one_iteration(args, algo_args, env_args, n_agents):
    runner = OnPolicyRunner(args, algo_args, env_args, device="cpu")
    state, metrics = runner.train_iteration(runner.init_state(0))
    assert tuple(metrics["actor_stats"].shape) == (n_agents, 4)
    assert bool(torch.isfinite(metrics["actor_stats"]).all())
    assert math.isfinite(float(metrics["value_loss"]))
    return runner, state


def test_unported_options_raise():
    """What is still refused raises; share_param, HATRPO and linear lr decay,
    refused before, run."""
    algo_args, env_args = _small_configs()
    for section, key, value in [("model", "initialization_method", "xavier_uniform_"),
                                ("model", "weight_decay", 1e-4)]:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            OnPolicyRunner(ARGS, _with(algo_args, section, key, value), env_args,
                           device="cpu").init_state(0)
    runner, state = _one_iteration(ARGS, _with(algo_args, "algo", "share_param", True),
                                   env_args, 6)
    assert len(state.actors) == 1 and runner.actors[0] is runner.actors[5]
    runner, state = _one_iteration(ARGS, _with(algo_args, "train", "use_linear_lr_decay", True),
                                   env_args, 6)
    assert state.actors[0].opt.lr_schedule is not None
    trpo_args, _ = get_defaults_yaml_args("hatrpo", "mamujoco_jax")
    trpo_args["train"].update(n_rollout_threads=4, episode_length=4)
    trpo_args["model"].update(hidden_sizes=[8, 8])
    trpo_args["algo"].update(critic_epoch=1)
    _one_iteration({"algo": "hatrpo", "env": "mamujoco_jax"}, trpo_args, env_args, 6)
    # the planar env has no FP state
    with pytest.raises(NotImplementedError, match="FP"):
        OnPolicyRunner(ARGS, algo_args, dict(env_args, state_type="FP"), device="cpu")


def _smaclite_configs():
    algo_args, env_args = get_defaults_yaml_args("happo", "smaclite")
    algo_args["train"].update(n_rollout_threads=3, episode_length=10)
    algo_args["model"].update(hidden_sizes=[8, 8], use_recurrent_policy=True,
                              data_chunk_length=5)
    algo_args["algo"].update(ppo_epoch=1, critic_epoch=1)
    env_args.update(map_name="3m", state_type="FP", episode_limit=6)
    return algo_args, env_args


SMAC_ARGS = {"algo": "happo", "env": "smaclite"}


def test_smaclite_path_defaults_to_cuda_and_refuses_unported_options():
    algo_args, env_args = _smaclite_configs()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            OnPolicyRunner(SMAC_ARGS, algo_args, env_args)
    # SMACv2's randomized maps, refused before, run (FP, GRU)
    runner, _ = _one_iteration(SMAC_ARGS, algo_args, dict(env_args, map_name="protoss_5_vs_5"),
                               5)
    assert runner.env.randomize_types and runner.share_obs_dim == runner.env.fp_state_dim
    # share_param and HATRPO, refused before, run (3m's marines are homogeneous)
    _one_iteration(SMAC_ARGS, _with(algo_args, "algo", "share_param", True), env_args, 3)
    trpo_args, _ = get_defaults_yaml_args("hatrpo", "smaclite")
    trpo_args["train"].update(n_rollout_threads=3, episode_length=10)
    trpo_args["model"].update(hidden_sizes=[8, 8], use_recurrent_policy=True,
                              data_chunk_length=5)
    trpo_args["algo"].update(critic_epoch=1)
    _one_iteration({"algo": "hatrpo", "env": "smaclite"}, trpo_args, env_args, 3)


def test_smaclite_cpu_path_runs_when_asked():
    algo_args, env_args = _smaclite_configs()
    runner = OnPolicyRunner(SMAC_ARGS, algo_args, env_args, device="cpu")
    state = runner.init_state(0)
    before = gae_kernels.gae.launches
    for _ in range(2):
        state, metrics = runner.train_iteration(state)
    assert gae_kernels.gae.launches == before
    assert tuple(metrics["actor_stats"].shape) == (3, 4)
    assert bool(torch.isfinite(metrics["actor_stats"]).all())
    assert math.isfinite(float(metrics["value_loss"]))
    assert set(metrics["episode_metric_sums"]) == {"won", "dead_allies", "dead_enemies"}
    assert float(metrics["episode_count"]) >= 3.0      # every env truncated at least once
    assert state.carry.critic_rnn.shape == (9, 1, 8)   # FP: one row per (env, agent)


# ---------------------------------------------------------------- off-policy
def _off_policy_configs(algo="hasac"):
    algo_args, env_args = get_defaults_yaml_args(algo, "mamujoco_jax")
    algo_args["train"].update(n_rollout_threads=3, warmup_steps=6, train_interval=2)
    algo_args["algo"].update(batch_size=8, buffer_size=50, n_step=2)
    algo_args["model"].update(hidden_sizes=[8, 8])
    env_args.update(agent_conf="2x3", episode_limit=3)
    return algo_args, env_args


def test_off_policy_runner_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    algo_args, env_args = _off_policy_configs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OffPolicyRunner({"algo": "hasac", "env": "mamujoco_jax"}, algo_args, env_args)


def test_off_policy_unported_options_raise():
    algo_args, env_args = _off_policy_configs()
    hasac = {"algo": "hasac", "env": "mamujoco_jax"}
    shared = {k: dict(v) if isinstance(v, dict) else v for k, v in algo_args.items()}
    shared["algo"]["share_param"] = True
    with pytest.raises(NotImplementedError, match="share_param.*ROADMAP"):
        OffPolicyRunner(hasac, shared, env_args, device="cpu")
    # the planar env has no FP state
    with pytest.raises(NotImplementedError, match="FP.*ROADMAP"):
        OffPolicyRunner(hasac, algo_args, dict(env_args, state_type="FP"), device="cpu")
    with pytest.raises(NotImplementedError, match="MultiDiscrete heads"):
        HASACActor(4, type("MultiDiscrete", (), {"nvec": (2, 3)})(), algo_args["model"] | {
            "lr": 1e-3, "polyak": 0.005})
    # HAD3QN and discrete HASAC, refused before, run: on MPE, and discrete
    # HASAC on SMACLite's EP state
    for algo, env, env_args_d in (("had3qn", "pettingzoo_mpe",
                                   {"scenario": "simple_spread_v2", "continuous_actions": False,
                                    "max_cycles": 3}),
                                  ("hasac", "pettingzoo_mpe",
                                   {"scenario": "simple_reference_v2",
                                    "continuous_actions": False, "max_cycles": 3}),
                                  ("hasac", "smaclite", {"map_name": "3m", "episode_limit": 3}),
                                  # the FP state, refused before, runs
                                  ("hasac", "smaclite", {"map_name": "3m", "episode_limit": 3,
                                                         "state_type": "FP"})):
        d_args, _ = get_defaults_yaml_args(algo, "pettingzoo_mpe")
        d_args["train"].update(n_rollout_threads=3, warmup_steps=6, train_interval=2)
        d_args["algo"].update(batch_size=8, buffer_size=50)
        d_args["model"].update(hidden_sizes=[8, 8])
        runner = OffPolicyRunner({"algo": algo, "env": env}, d_args, env_args_d, device="cpu")
        state = runner.warmup_block(runner.init_state(0))
        state, cm = runner.collect_block(state)
        state, tm = runner.train_block(state)
        assert runner.discrete and state.buffer.available_actions is not None
        assert state.buffer.share_obs.dim() == (3 if env_args_d.get("state_type") == "FP"
                                                else 2)
        assert math.isfinite(float(tm["critic_loss"])) and state.total_it == 2
    with pytest.raises(NotImplementedError, match="host.*ROADMAP"):
        OffPolicyRunner({"algo": "hasac", "env": "mamujoco"}, algo_args, env_args,
                        device="cpu")
    # the training loop and evaluation, refused before, run; meshes do not
    algo_args["train"].update(num_env_steps=12, eval_interval=2)
    algo_args["eval"].update(use_eval=True, n_eval_rollout_threads=2, eval_episodes=2)
    runner = OffPolicyRunner(hasac, algo_args, env_args, device="cpu")
    state, history = runner.run(seed=0)
    assert len(history) == 2 and math.isfinite(history[-1]["eval_return"])
    assert math.isfinite(runner.evaluate(state, 2, 2)[0])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        runner.run(seed=0, mesh=object())


@pytest.mark.parametrize("algo", ["hasac", "hatd3"])
def test_off_policy_cpu_path_runs_when_asked(algo):
    algo_args, env_args = _off_policy_configs(algo)
    runner = OffPolicyRunner({"algo": algo, "env": "mamujoco_jax"}, algo_args, env_args,
                             device="cpu")
    state = runner.warmup_block(runner.init_state(0))
    before = gae_kernels.gae.launches
    for block in range(2):
        state, cm = runner.collect_block(state)
        state, tm = runner.train_block(state)
    assert gae_kernels.gae.launches == before
    assert state.buffer.cur_size == 6 + 2 * 2 * 3
    assert state.total_it == 4
    assert math.isfinite(float(tm["critic_loss"]))
    assert tm["critic_loss"].device.type == "cpu"
