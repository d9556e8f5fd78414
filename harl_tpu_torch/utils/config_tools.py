"""Config loading, overriding and run-directory bookkeeping (counterpart of
``harl_tpu/utils/config_tools.py``; reference ``harl/utils/configs_tools.py``):
the port's YAML defaults per algo and env, the recursive leaf-only CLI
override, the results layout
``results/<env>/<task>/<algo>/<exp>/seed-XXXXX-<time>/{logs,models}`` and the
JSON snapshot of the merged config."""
from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Dict, Tuple

import yaml

CONFIG_ROOT = Path(__file__).resolve().parent.parent / "configs"


def get_defaults_yaml_args(algo: str, env: str) -> Tuple[Dict, Dict]:
    """Load the algo and env default YAMLs shipped with the port, one for
    every YAML of the JAX package; a name without one raises
    ``FileNotFoundError``."""
    algo_path = CONFIG_ROOT / "algos_cfgs" / f"{algo}.yaml"
    env_path = CONFIG_ROOT / "envs_cfgs" / f"{env}.yaml"
    with open(algo_path) as f:
        algo_args = yaml.safe_load(f)
    with open(env_path) as f:
        env_args = yaml.safe_load(f) or {}
    return algo_args, env_args


def update_args(unparsed: Dict[str, Any], *args_dicts: Dict) -> None:
    """Override every matching leaf key in the nested dicts
    (configs_tools.py:29-45). A dict-valued entry is recursed into, never
    replaced: ``--seed 2`` sets seed.seed and keeps the seed section."""

    def update_recursive(d: Dict, k: str, v) -> bool:
        found = False
        if k in d and not isinstance(d[k], dict):
            d[k] = v
            found = True
        for sub in d.values():
            if isinstance(sub, dict) and update_recursive(sub, k, v):
                found = True
        return found

    for k, v in unparsed.items():
        for d in args_dicts:
            update_recursive(d, k, v)


def get_task_name(env: str, env_args: Dict) -> str:
    """Task id per env family (configs_tools.py:48-69)."""
    if env in ("pettingzoo_mpe", "mpe"):
        mode = "continuous" if env_args.get("continuous_actions", True) else "discrete"
        return f"{env_args.get('scenario', 'simple_spread_v2')}-{mode}"
    if env == "mamujoco":
        return f"{env_args.get('scenario', '')}-{env_args.get('agent_conf', '')}"
    if env in ("smac", "smacv2", "smax"):
        return env_args.get("map_name", "unknown")
    if env in ("football", "football_jax"):
        return env_args.get("env_name", "unknown")
    if env == "gym":
        return env_args.get("scenario", "unknown")
    if env in ("dexhands", "dexhands_jax"):
        return env_args.get("task", "ShadowHandOver")
    return env_args.get("scenario", env)


def init_dir(env, env_args, algo, exp_name, seed, logger_path="./results"):
    """Create the run directory tree; returns (run_dir, log_dir, save_dir)
    (configs_tools.py:72-91)."""
    task = get_task_name(env, env_args)
    hms = time.strftime("%Y%m%d_%H%M%S")
    run_dir = Path(logger_path) / env / task / algo / exp_name / f"seed-{seed:0>5}-{hms}"
    log_dir = run_dir / "logs"
    save_dir = run_dir / "models"
    log_dir.mkdir(parents=True, exist_ok=True)
    save_dir.mkdir(parents=True, exist_ok=True)
    return str(run_dir), str(log_dir), str(save_dir)


def save_config(args, algo_args, env_args, run_dir) -> None:
    """JSON snapshot for ``--load_config`` (configs_tools.py:129-135)."""
    config = {"main_args": args, "algo_args": algo_args, "env_args": env_args}
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2, default=str)


def load_config(path: str):
    """(main_args, algo_args, env_args) of a saved config.json."""
    with open(path) as f:
        cfg = json.load(f)
    return cfg["main_args"], cfg["algo_args"], cfg["env_args"]
