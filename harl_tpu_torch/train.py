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

Data parallelism (``parallel/mesh.py``), as the JAX CLI's flags:

  * ``--n_devices K`` (K > 1), or no ``n_devices`` with several CUDA
    devices visible: K worker processes on this host, rank k on ``cuda:k``
    over NCCL (``--platform cpu``: K gloo workers on the CPU);
  * ``--num_processes P --coordinator host:port --process_id p``: P such
    processes (one a host), ``P × K`` ranks in all, meeting at the
    coordinator; ``process_id`` defaults to the launcher's ``$RANK``.

``n_rollout_threads`` is the global env batch, split over the ranks. The
process with ``process_id`` 0 alone creates the run directory, and its
first rank alone logs and writes checkpoints. A worker that fails makes
``main`` raise. A host env (``--env mamujoco``, ``gym``, the real games)
trains on one rank: with more, ``main`` raises ``ValueError`` before it
starts any, where the JAX CLI ignores the mesh and would leave
unsynchronised replicas.
"""
from __future__ import annotations

import argparse
import ast
import os

ON_POLICY = ("happo", "hatrpo", "haa2c", "mappo")
ALGOS = ON_POLICY + ("haddpg", "hatd3", "hasac", "had3qn", "maddpg", "matd3")
# the device section's keys, the JAX CLI's flags of data parallelism
DEVICE_FLAGS = ("platform", "n_devices", "num_processes", "coordinator", "process_id")


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
    """The run's device type from ``device.platform`` (a data-parallel
    worker takes its own index of it)."""
    from harl_tpu_torch.utils.device import resolve_device

    platform = (algo_args.get("device", {}) or {}).get("platform")
    if platform in (None, "gpu", "cuda"):
        return resolve_device(None)
    if platform == "cpu":
        return resolve_device("cpu")
    raise ValueError(f"device.platform {platform!r}: expected null, 'gpu', 'cuda' or 'cpu'")


def local_workers(algo_args: dict, device) -> int:
    """This process's data-parallel workers: ``device.n_devices``, or with
    none given every visible CUDA device (the JAX CLI's
    ``len(jax.devices()) > 1``), one on the CPU."""
    import torch

    n = (algo_args.get("device", {}) or {}).get("n_devices")
    if n is None:
        n = torch.cuda.device_count() if device.type == "cuda" else 1
    if device.type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"device.n_devices {n}: {torch.cuda.device_count()} CUDA devices")
    return max(int(n), 1)


def _train(args, algo_args, env_args, device, seed, dirs, mesh=None) -> None:
    """Build the runner and train (or render) on ``device``; ``dirs`` is
    (run_dir, log_dir, save_dir), the first two None on a rank that does
    not log."""
    from harl_tpu_torch.logging.logger import TrainLogger

    if args["algo"] in ON_POLICY:
        from harl_tpu_torch.runners.on_policy import OnPolicyRunner as Runner
    else:
        from harl_tpu_torch.runners.off_policy import OffPolicyRunner as Runner
    run_dir, log_dir, save_dir = dirs
    runner = Runner(args, algo_args, env_args, device=device)
    logger = (TrainLogger(args, algo_args, env_args, runner.n_agents, log_dir)
              if log_dir is not None else None)
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
            runner.run(seed=seed, logger=logger, save_dir=save_dir, mesh=mesh)
    finally:
        if logger is not None:
            logger.close()


def _worker(local_rank, args, algo_args, env_args, seed, dirs, dp) -> None:
    """One data-parallel rank: join the group, train its env columns."""
    import torch

    from harl_tpu_torch.parallel import mesh as dpmesh
    from harl_tpu_torch.utils.device import resolve_device

    rank = dp["process_id"] * dp["local"] + local_rank
    if dp["device_type"] == "cuda":
        torch.cuda.set_device(local_rank)
        device = resolve_device(f"cuda:{local_rank}")
    else:
        device = resolve_device("cpu")
    # the local ranks share the host's cores, on the CPU and on the cards
    # alike (parallel/launch.py)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // dp["local"]))
    dpmesh.distributed_init(dp["coordinator"], dp["world"], rank,
                            "nccl" if device.type == "cuda" else "gloo")
    try:
        if rank:
            # only rank 0 logs and writes; the others still take part in
            # the checkpoints' gathers wherever rank 0 saves
            dirs = (None, None, None if dirs[2] is None else "")
        _train(args, algo_args, env_args, device, seed, dirs,
               dpmesh.make_mesh(device))
        if device.type == "cuda":
            # the last checkpoint's gather, queued on the card while rank 0
            # still evaluates, must end before the group is destroyed
            torch.cuda.synchronize(device)
    finally:
        dpmesh.shutdown()


def resolve_args(argv=None) -> tuple:
    """(main args, algo args, env args) of a command line: the saved config
    or the YAML defaults with the ``--key value`` overrides applied, as the
    JAX CLI resolves them (``harl_tpu/train.py:34-63``). The data-parallel
    flags of ``DEVICE_FLAGS`` given on the command line also apply where a
    saved config's device section lacks them (the on-policy tuned configs
    name only ``platform`` and ``n_devices``), where the JAX CLI drops
    them."""
    parser = argparse.ArgumentParser(description="HARL training on PyTorch/CUDA")
    parser.add_argument("--algo", default="happo", choices=list(ALGOS))
    parser.add_argument("--env", default="pettingzoo_mpe")
    parser.add_argument("--exp_name", default="installtest")
    parser.add_argument("--load_config", default="")
    args, unparsed = parser.parse_known_args(argv)
    args = vars(args)

    from harl_tpu_torch.utils.config_tools import (get_defaults_yaml_args, load_config,
                                                   update_args)

    if args["load_config"]:
        saved_main, algo_args, env_args = load_config(args["load_config"])
        args["algo"] = saved_main.get("algo", args["algo"])
        args["env"] = saved_main.get("env", args["env"])
    else:
        algo_args, env_args = get_defaults_yaml_args(args["algo"], args["env"])
    overrides = _parse_unknown(unparsed)
    update_args(overrides, algo_args, env_args)
    device = algo_args.setdefault("device", {})
    for key in DEVICE_FLAGS:
        if key in overrides and key not in device:
            device[key] = overrides[key]
    return args, algo_args, env_args


def main(argv=None) -> str:
    """Train (or render) as the command line says; returns the run
    directory (None in a process other than ``process_id`` 0)."""
    from harl_tpu_torch.utils.config_tools import init_dir, save_config

    args, algo_args, env_args = resolve_args(argv)
    device = select_device(algo_args)
    dev = algo_args.get("device", {}) or {}
    n_local = local_workers(algo_args, device)
    num_processes = dev.get("num_processes") or 1
    rendering = (algo_args.get("render", {}) or {}).get("use_render", False)
    process_id = 0
    if num_processes > 1:
        if not dev.get("coordinator"):
            raise ValueError("device.num_processes > 1 needs device.coordinator (host:port)")
        process_id = dev.get("process_id")
        if process_id is None:
            process_id = int(os.environ.get("RANK", 0))

    world = num_processes * n_local
    if world > 1 and not rendering:
        from harl_tpu_torch.envs import is_host_env

        if is_host_env(args["env"], env_args):
            raise ValueError(f"host env {args['env']!r}: data parallelism over {world} ranks "
                             "needs a tensor env; train it on one (--n_devices 1)")
    seed = algo_args["seed"]["seed"] if algo_args["seed"].get("seed_specify", True) else 1
    dirs = (None, None, "")
    if process_id == 0:
        dirs = init_dir(args["env"], env_args, args["algo"], args["exp_name"], seed,
                        algo_args.get("logger", {}).get("log_dir", "./results"))
        save_config(args, algo_args, env_args, dirs[0])
    if world == 1 or rendering:
        _train(args, algo_args, env_args, device, seed, dirs)
    else:
        from harl_tpu_torch.parallel.launch import free_port

        dp = dict(world=world, local=n_local, process_id=process_id,
                  device_type=device.type,
                  coordinator=dev.get("coordinator") or f"localhost:{free_port()}")
        print(f"data parallelism over {world} ranks ({n_local} in this process)")
        worker_args = (args, algo_args, env_args, seed, dirs, dp)
        if n_local == 1:
            _worker(0, *worker_args)
        else:
            import torch.multiprocessing as mp

            # raises, after stopping the others, when a worker fails
            mp.spawn(_worker, args=worker_args, nprocs=n_local, join=True)
    if dirs[0] is not None:
        print(f"results saved under {dirs[0]}")
    return dirs[0]


if __name__ == "__main__":
    main()
