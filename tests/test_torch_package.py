"""The port's package boundary: no JAX, no ``harl_tpu``, CUDA by default."""
import math
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from harl_tpu_torch.ops import gae_kernels
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


def test_imports_no_jax_and_no_harl_tpu():
    """Every module of the package imports with JAX, flax and optax made
    unimportable, and loads nothing of harl_tpu."""
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
        assert "harl_tpu_torch.runners.on_policy" in names, names
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


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


def test_unported_options_raise():
    algo_args, env_args = _small_configs()
    for section, key, value in [("algo", "share_param", True),
                                ("model", "use_recurrent_policy", True),
                                ("train", "use_linear_lr_decay", True)]:
        a = {k: dict(v) if isinstance(v, dict) else v for k, v in algo_args.items()}
        a[section][key] = value
        with pytest.raises(NotImplementedError):
            OnPolicyRunner(ARGS, a, env_args, device="cpu").init_state(0)
    with pytest.raises(NotImplementedError):
        OnPolicyRunner({"algo": "hatrpo", "env": "mamujoco_jax"}, algo_args, env_args,
                       device="cpu")
