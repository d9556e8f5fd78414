"""The host envs through the port's entry point, ``python -m
harl_tpu_torch.train`` on the CPU: tiny ``--env mamujoco`` and ``--env
gym`` runs on both runners (the run directory, evaluation, checkpoints), a
host render, the env YAMLs against the JAX package's, and the refusal of a
host env under more than one data-parallel rank."""
import copy
import glob
import json
import math
import os
from pathlib import Path

import pytest

from harl_tpu.utils import config_tools as jconfig
from harl_tpu_torch import train
from harl_tpu_torch.parallel.launch import spawn_ranks
from harl_tpu_torch.parallel.mesh import Mesh
from harl_tpu_torch.runners.off_policy import OffPolicyRunner
from harl_tpu_torch.runners.on_policy import OnPolicyRunner
from harl_tpu_torch.utils import config_tools as tconfig

TINY_ON = ["--platform", "cpu", "--n_rollout_threads", "2", "--episode_length", "10",
           "--num_env_steps", "40", "--hidden_sizes", "[8, 8]", "--ppo_epoch", "1",
           "--critic_epoch", "1", "--use_eval", "True", "--eval_interval", "1",
           "--log_interval", "1", "--n_eval_rollout_threads", "2"]
TINY_OFF = ["--platform", "cpu", "--n_rollout_threads", "2", "--warmup_steps", "8",
            "--train_interval", "2", "--batch_size", "8", "--buffer_size", "200",
            "--hidden_sizes", "[8, 8]", "--num_env_steps", "16", "--eval_interval", "4",
            "--use_eval", "True", "--eval_episodes", "2", "--n_eval_rollout_threads", "2"]
MUJOCO = ["--env", "mamujoco", "--scenario", "HalfCheetah-v2", "--agent_conf", "2x3",
          "--episode_limit", "6"]
GYM = ["--env", "gym", "--scenario", "CartPole-v1"]


def _run_dir(log_dir):
    (run,) = glob.glob(str(log_dir / "*/*/*/*/seed-*"))
    return Path(run)


def _records(run):
    with open(run / "logs" / "progress.txt") as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("env", ["mamujoco", "gym"])
def test_env_yamls_are_the_jax_packages(env):
    assert tconfig.get_defaults_yaml_args("happo", env) == jconfig.get_defaults_yaml_args(
        "happo", env)


@pytest.mark.parametrize("algo,env_argv", [("happo", MUJOCO), ("happo", GYM)],
                         ids=["mamujoco", "gym"])
def test_main_on_policy_trains_a_host_env(tmp_path, algo, env_argv):
    run = Path(train.main(["--algo", algo, *env_argv, *TINY_ON, "--log_dir", str(tmp_path)]))
    assert run == _run_dir(tmp_path)
    env = env_argv[1]
    task = "HalfCheetah-v2-2x3" if env == "mamujoco" else "CartPole-v1"
    assert run.relative_to(tmp_path).parts[:3] == (env, task, algo)
    recs = _records(run)
    train_recs = [r for r in recs if "value_loss" in r]
    evals = [r for r in recs if "eval_return" in r]
    assert [r["steps"] for r in train_recs] == [20, 40] and len(evals) == 2
    assert all(math.isfinite(r["value_loss"]) for r in train_recs)
    assert all(math.isfinite(r["eval_return"]) for r in evals)
    assert sorted(os.listdir(run / "models")) == ["ckpt_20", "ckpt_40"]


@pytest.mark.parametrize("algo,env_argv", [("hatd3", MUJOCO), ("had3qn", GYM)],
                         ids=["hatd3-mamujoco", "had3qn-gym"])
def test_main_off_policy_trains_a_host_env(tmp_path, algo, env_argv):
    run = Path(train.main(["--algo", algo, *env_argv, *TINY_OFF, "--log_dir", str(tmp_path)]))
    recs = _records(run)
    # 4 blocks of 2 steps × 2 envs after 8 warmup steps; a record every 2 blocks
    assert [r["steps"] for r in recs] == [16, 24]
    assert all(math.isfinite(r["critic_loss"]) and "eval_return" in r for r in recs)
    assert os.listdir(run / "models") == ["ckpt_24"]


def test_main_renders_a_host_env(tmp_path, capsys):
    train.main(["--algo", "happo", *GYM, *TINY_ON, "--use_render", "True",
                "--render_episodes", "2", "--log_dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "render episode 1: return" in out and "render returns:" in out
    # the native engine renders as a batch of one (no viewer: render() is
    # skipped where it raises)
    algo_args, env_args = tconfig.get_defaults_yaml_args("happo", "mamujoco")
    algo_args["train"].update(n_rollout_threads=2, episode_length=5)
    algo_args["model"]["hidden_sizes"] = [8, 8]
    env_args.update(agent_conf="2x3", episode_limit=4)
    runner = OnPolicyRunner({"algo": "happo", "env": "mamujoco"}, algo_args, env_args,
                            device="cpu")
    returns = runner.render(runner.init_state(0), episodes=2)
    assert len(returns) == 2 and all(math.isfinite(r) for r in returns)


def test_main_refuses_a_host_env_on_several_ranks(tmp_path):
    for argv in (MUJOCO, GYM):
        with pytest.raises(ValueError, match="host env.*2 ranks"):
            train.main(["--algo", "happo", *argv, *TINY_ON, "--n_devices", "2",
                        "--log_dir", str(tmp_path)])
    assert not os.listdir(tmp_path)          # refused before any run directory


def _configs(algo, env):
    algo_args, env_args = tconfig.get_defaults_yaml_args(algo, env)
    algo_args["train"].update(n_rollout_threads=2, episode_length=4, warmup_steps=4,
                              train_interval=2)
    algo_args["algo"].update(batch_size=4, buffer_size=50)
    algo_args["model"]["hidden_sizes"] = [8, 8]
    return algo_args, env_args


def _run_on_ranks(mesh, runner_cls, algo, env):
    """One rank: build a host-env runner and run it over the process group;
    returns the refusal's message."""
    algo_args, env_args = _configs(algo, env)
    runner = runner_cls({"algo": algo, "env": env}, algo_args, env_args, device="cpu")
    try:
        runner.run(seed=1, mesh=mesh)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("runner_cls,algo", [(OnPolicyRunner, "happo"),
                                             (OffPolicyRunner, "hatd3")])
def test_runners_refuse_a_host_env_under_two_ranks(runner_cls, algo):
    algo_args, env_args = _configs(algo, "gym")
    if algo == "hatd3":
        env_args["scenario"] = "Pendulum-v1"
    runner = runner_cls({"algo": algo, "env": "gym"}, copy.deepcopy(algo_args), env_args,
                        device="cpu")
    with pytest.raises(ValueError, match="host env 'gym': data parallelism over 2 ranks"):
        runner.use_mesh(Mesh(0, 2, "cpu"))
    runner.use_mesh(None)                    # one rank: the host path
    assert runner.vec is runner.host_vec and runner.n_envs == 2
    if algo == "happo":
        # two gloo ranks of one process group, each refusing
        messages = spawn_ranks(_run_on_ranks, 2, (runner_cls, algo, "mamujoco"))
        assert all("host env 'mamujoco'" in m for m in messages), messages


def test_model_dir_off_policy_host_skips_on_policy_host_restores(tmp_path):
    """As in the JAX package: the off-policy host loop starts before any
    ``model_dir`` restore (off_policy.py:951-954), so a missing checkpoint
    goes unread; the on-policy ``run`` restores first
    (on_policy.py:1031-1033)."""
    missing = str(tmp_path / "no_checkpoint")
    algo_args, env_args = _configs("hatd3", "gym")
    algo_args["train"].update(model_dir=missing, num_env_steps=4)
    algo_args["eval"]["use_eval"] = False
    env_args["scenario"] = "Pendulum-v1"
    state, history = OffPolicyRunner({"algo": "hatd3", "env": "gym"}, algo_args, env_args,
                                     device="cpu").run(seed=1)
    assert state.total_it == 2 and len(history) == 1
    algo_args, env_args = _configs("happo", "gym")
    algo_args["train"].update(model_dir=missing, num_env_steps=8)
    with pytest.raises(FileNotFoundError):
        OnPolicyRunner({"algo": "happo", "env": "gym"}, algo_args, env_args,
                       device="cpu").run(seed=1)
