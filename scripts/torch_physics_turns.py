#!/usr/bin/env python3
"""Time the HalfCheetah-6x1 physics of two checkouts of the PyTorch port in
turns on one CUDA device: A, B, B, A.

    python scripts/torch_physics_turns.py ROOT_A ROOT_B [--iterations 4]

Each root is a directory holding a ``harl_tpu_torch`` package, for example
an earlier commit's, unpacked with ``git archive`` into a directory that
``.gitignore`` lists. Every turn is a process of its own, with its root
first on ``sys.path``. At 4,096 and at 20 envs it resets that many envs
from seed 0 and warms them 40 env steps with random actions, then times 100
calls of ``physics_step`` (``frame_skip`` substeps; host clock, the last
ending in a synchronise, after 5 untimed calls) as wall µs an env step.
With ``--iterations N`` it then runs N main-path iterations of that package
(HAPPO HalfCheetah-6x1, 4096 envs x 32 steps, ``make_runner`` of this
repository's ``chip_smoke.py``) and reports env-steps/s over all but the
first. Last, since a profiler session slows the process for good, it
counts the device ops of one ``physics_step`` under ``torch.profiler``
(``count_device_ops``) and divides them by ``frame_skip``. It prints one
JSON line per turn, then the two roots side by side.
"""
from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
ENV_ARGS = {"scenario": "HalfCheetah-v2", "agent_conf": "6x1"}
WIDTHS = (4096, 20)
REPS = 100


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def physics_at(width: int, reps: int, device: str = "cuda"):
    """(the env, its warmed (q, qd), actions) and wall µs an env step."""
    import torch

    from harl_tpu_torch.envs.mamujoco_jax.planar import make_planar

    env = make_planar(ENV_ARGS, torch.device(device))
    rng = np.random.default_rng(0)
    dof, nj = env.spec.dof, env.spec.n_joints
    cuda = lambda x: torch.as_tensor(x, device=device)
    st, _ = env.reset((cuda(rng.random((width, dof), np.float32)),
                       cuda(rng.standard_normal((width, dof), np.float32))))
    q, qd = st.q, st.qd
    for _ in range(40):
        q, qd = env.dyn.physics_step(q, qd, cuda(rng.uniform(-1, 1, (width, nj))
                                                 .astype(np.float32)))
    act = cuda(rng.uniform(-1, 1, (width, nj)).astype(np.float32))
    for _ in range(5):
        env.dyn.physics_step(q, qd, act)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        env.dyn.physics_step(q, qd, act)
    torch.cuda.synchronize()
    return (env, q, qd, act), (time.perf_counter() - t0) / reps * 1e6


def one_turn(root: str, iterations: int) -> None:
    root_path = Path(root).resolve()
    sys.path.insert(0, str(root_path))
    smoke = _load("chip_smoke_physics", REPO / "chip_smoke.py")
    import harl_tpu_torch

    package = Path(harl_tpu_torch.__file__).resolve()
    if root_path not in package.parents:
        raise RuntimeError(f"imported {package}, not the package under {root_path}")
    out = {"root": root, "card": smoke.card_line(), "widths": {}}
    kept = {}
    for w in WIDTHS:
        kept[w], us = physics_at(w, REPS)
        out["widths"][str(w)] = {"wall_us_an_env_step": us}
    if iterations > 1:
        gae_turns = _load("torch_gae_turns", REPO / "scripts" / "torch_gae_turns.py")
        out["env_steps_per_s"] = gae_turns.main_path_steps_per_s(smoke, iterations)
    for w in WIDTHS:
        env, q, qd, act = kept[w]
        ops, ms = smoke.count_device_ops(lambda: env.dyn.physics_step(q, qd, act))
        out["widths"][str(w)].update(device_ops_a_substep=ops / env.spec.frame_skip,
                                     profiled_device_ms_an_env_step=ms)
    print(json.dumps(out), flush=True)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--one", action="store_true", help="one turn on one root (internal)")
    ap.add_argument("--iterations", type=int, default=0)
    args = ap.parse_args(argv)
    if args.one:
        one_turn(args.roots[0], args.iterations)
        return 0
    gae_turns = _load("torch_gae_turns", REPO / "scripts" / "torch_gae_turns.py")
    a, b = args.roots
    turns = gae_turns.run_turns(__file__, a, b, ["--iterations", str(args.iterations)])
    summary = functools.partial(gae_turns.print_summary, turns, a, b)
    for w in WIDTHS:
        for key in ("wall_us_an_env_step", "device_ops_a_substep",
                    "profiled_device_ms_an_env_step"):
            summary(f"{w} envs {key}", lambda t: t["widths"][str(w)][key], "{:.2f}")
    if args.iterations > 1:
        summary("main path env-steps/s", lambda t: t["env_steps_per_s"], "{:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
