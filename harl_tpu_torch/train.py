"""Training entry point of the port (counterpart of ``harl_tpu/train.py``;
reference ``examples/train.py``):

    python -m harl_tpu_torch.train --algo hatrpo --env smaclite --exp_name x [--key value ...]
    python -m harl_tpu_torch.train --load_config tuned_configs/smaclite/5m_vs_6m/hatrpo/config.json

Every ``--key value`` pair overrides the matching leaf keys of the YAML
defaults (or of the saved config), the value read with ``ast.literal_eval``.
The device comes from ``device.platform``: null, "gpu" or "cuda" run on CUDA
and raise on a host without it; "cpu" (``--platform cpu``) runs on the CPU.
The run goes to ``<log_dir>/<env>/<task>/<algo>/<exp>/seed-XXXXX-<time>/``
with ``config.json``, ``logs/progress.txt`` and ``models/ckpt_<step>``.
"""
from __future__ import annotations

import argparse
import ast

from harl_tpu_torch.runners.common import MESH_TODO

ON_POLICY = ("happo", "hatrpo", "haa2c", "mappo")
ALGOS = ON_POLICY + ("haddpg", "hatd3", "hasac", "had3qn", "maddpg", "matd3")


def _parse_unknown(unparsed):
    """--key value pairs → dict with literal-eval'd values; a bare --flag is
    True (train.py:57-65)."""
    out = {}
    key = None
    for tok in unparsed:
        if tok.startswith("--"):
            key = tok[2:]
            out[key] = True
        elif key is not None:
            try:
                out[key] = ast.literal_eval(tok)
            except (ValueError, SyntaxError):
                out[key] = tok
            key = None
    return out


def select_device(algo_args: dict):
    """The run's device from ``device.platform``; ``NotImplementedError``
    for more than one device or process."""
    from harl_tpu_torch.utils.device import resolve_device

    dev = algo_args.get("device", {}) or {}
    for key in ("n_devices", "num_processes"):
        if (dev.get(key) or 1) > 1:
            raise NotImplementedError(f"device.{key} = {dev[key]}: {MESH_TODO}")
    platform = dev.get("platform")
    if platform in (None, "gpu", "cuda"):
        return resolve_device(None)
    if platform == "cpu":
        return resolve_device("cpu")
    raise ValueError(f"device.platform {platform!r}: expected null, 'gpu', 'cuda' or 'cpu'")


def main(argv=None) -> str:
    """Train (or render) as the command line says; returns the run directory."""
    parser = argparse.ArgumentParser(description="HARL training on PyTorch/CUDA")
    parser.add_argument("--algo", default="happo", choices=list(ALGOS))
    parser.add_argument("--env", default="pettingzoo_mpe")
    parser.add_argument("--exp_name", default="installtest")
    parser.add_argument("--load_config", default="")
    args, unparsed = parser.parse_known_args(argv)
    args = vars(args)

    from harl_tpu_torch.logging.logger import TrainLogger
    from harl_tpu_torch.utils.config_tools import (get_defaults_yaml_args, init_dir,
                                                   load_config, save_config, update_args)

    if args["load_config"]:
        saved_main, algo_args, env_args = load_config(args["load_config"])
        args["algo"] = saved_main.get("algo", args["algo"])
        args["env"] = saved_main.get("env", args["env"])
    else:
        algo_args, env_args = get_defaults_yaml_args(args["algo"], args["env"])
    update_args(_parse_unknown(unparsed), algo_args, env_args)
    device = select_device(algo_args)

    seed = algo_args["seed"]["seed"] if algo_args["seed"].get("seed_specify", True) else 1
    run_dir, log_dir, save_dir = init_dir(
        args["env"], env_args, args["algo"], args["exp_name"], seed,
        algo_args.get("logger", {}).get("log_dir", "./results"))
    save_config(args, algo_args, env_args, run_dir)

    if args["algo"] in ON_POLICY:
        from harl_tpu_torch.runners.on_policy import OnPolicyRunner as Runner
    else:
        from harl_tpu_torch.runners.off_policy import OffPolicyRunner as Runner
    runner = Runner(args, algo_args, env_args, device=device)
    logger = TrainLogger(args, algo_args, env_args, runner.n_agents, log_dir)
    try:
        if (algo_args.get("render", {}) or {}).get("use_render", False):
            if args["algo"] not in ON_POLICY:
                raise ValueError("use_render: only the on-policy runner renders")
            state = runner.init_state(seed)
            model_dir = algo_args["train"].get("model_dir")
            if model_dir:
                state = runner.restore(state, model_dir)
            episodes = algo_args["render"].get("render_episodes", 10)
            returns = runner.render(state, episodes, save_path=f"{run_dir}/render.npz")
            print("render returns:", [round(r, 2) for r in returns])
        else:
            runner.run(seed=seed, logger=logger, save_dir=save_dir)
    finally:
        logger.close()
    print(f"results saved under {run_dir}")
    return run_dir


if __name__ == "__main__":
    main()
