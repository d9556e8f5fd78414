"""Default YAML configs of the port (counterpart of
``harl_tpu/utils/config_tools.py:get_defaults_yaml_args``)."""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import yaml

CONFIG_ROOT = Path(__file__).resolve().parent.parent / "configs"


def get_defaults_yaml_args(algo: str, env: str) -> Tuple[Dict, Dict]:
    """Load the algo and env default YAMLs shipped with the port."""
    algo_path = CONFIG_ROOT / "algos_cfgs" / f"{algo}.yaml"
    env_path = CONFIG_ROOT / "envs_cfgs" / f"{env}.yaml"
    for path in (algo_path, env_path):
        if not path.exists():
            raise NotImplementedError(
                f"{path.name}: the port ships only happo.yaml, hasac.yaml, haddpg.yaml, "
                "hatd3.yaml, maddpg.yaml, matd3.yaml, mamujoco_jax.yaml and "
                "smaclite.yaml so far (ROADMAP.md, Queue A)"
            )
    with open(algo_path) as f:
        algo_args = yaml.safe_load(f)
    with open(env_path) as f:
        env_args = yaml.safe_load(f) or {}
    return algo_args, env_args
