#!/usr/bin/env python3
"""Time the GAE and discounted-return kernels of two checkouts of the
PyTorch port in turns on one CUDA device: A, B, B, A.

    python scripts/torch_gae_turns.py ROOT_A ROOT_B [--shapes T:b,...] [--iterations N]

Each root is a directory holding a ``harl_tpu_torch`` package, for example
an earlier commit's, unpacked with ``git archive <commit> harl_tpu_torch``
into a directory that ``.gitignore`` lists. Every turn is a process of its
own, with its root first on ``sys.path``, that builds that package's
``csrc/gae.cu`` and times both kernels through their wrappers with
``time_kernels`` of this repository's ``chip_smoke.py``: at the main path's
shape and the SMACLite FP shape (or at ``--shapes``: T rows of b columns),
warm and cold, with the host's cost of a call and the empty-launch floor.
With ``--iterations N`` a turn then runs N main-path iterations of that
package (HAPPO HalfCheetah-6x1, 4096 envs x 32 steps) and reports
env-steps/s over all but the first. It prints one JSON line per turn and
then a summary of the two roots side by side.
"""
from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def parse_shapes(spec: str):
    """"32:4096,70:1280" -> (("T32_b4096", 32, (4096,)), ("T70_b1280", 70, (1280,)))."""
    shapes = []
    for item in spec.split(","):
        T, b = (int(x) for x in item.split(":"))
        shapes.append((f"T{T}_b{b}", T, (b,)))
    return tuple(shapes)


def main_path_steps_per_s(smoke, iterations: int) -> float:
    import torch

    n, T = smoke.MAIN["n_envs"], smoke.MAIN["episode_length"]
    runner = smoke.make_runner(n, T, smoke.MAIN["hidden"], "cuda")
    state = runner.init_state(0)
    times = []
    for _ in range(iterations):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = runner.train_iteration(state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return n * T * (iterations - 1) / sum(times[1:])


def one_turn(root: str, shape_spec: str, iterations: int) -> None:
    root_path = Path(root).resolve()
    sys.path.insert(0, str(root_path))
    spec = importlib.util.spec_from_file_location("chip_smoke_timing", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import harl_tpu_torch

    package = Path(harl_tpu_torch.__file__).resolve()
    if root_path not in package.parents:
        raise RuntimeError(f"imported {package}, not the package under {root_path}")
    shapes = parse_shapes(shape_spec) if shape_spec else smoke.TIMED_SHAPES
    timing, floor = smoke.time_kernels("cuda", shapes)
    steps = main_path_steps_per_s(smoke, iterations) if iterations > 1 else None
    print(json.dumps({"root": root, "timing": timing, "floor": floor,
                      "env_steps_per_s": steps}), flush=True)


def run_turns(script: str, a: str, b: str, argv: list) -> list:
    """``script --one ROOT *argv`` for the roots A, B, B, A, each a process
    of its own; prints and returns each turn's JSON line."""
    turns = []
    for root in (a, b, b, a):
        out = subprocess.run([sys.executable, script, "--one", root, *argv],
                             capture_output=True, text=True, timeout=900)
        sys.stderr.write(out.stderr)
        if out.returncode != 0:
            raise SystemExit(f"turn on {root} failed ({out.returncode})")
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        turns.append(json.loads(line))
    return turns


def print_summary(turns: list, a: str, b: str, label: str, get, fmt: str = "{:.3f}") -> None:
    """One line: ``get`` of each turn, by root, and each root's median."""
    vals = {root: [get(t) for t in turns if t["root"] == root] for root in (a, b)}
    print(f"{label}: " + "; ".join(
        f"{root} {' '.join(fmt.format(v) for v in vs)} (median {fmt.format(statistics.median(vs))})"
        for root, vs in vals.items()), flush=True)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--one", action="store_true", help="one turn on one root (internal)")
    ap.add_argument("--shapes", default="")
    ap.add_argument("--iterations", type=int, default=0)
    args = ap.parse_args(argv)
    if args.one:
        one_turn(args.roots[0], args.shapes, args.iterations)
        return 0
    a, b = args.roots
    turns = run_turns(__file__, a, b, ["--shapes", args.shapes,
                                       "--iterations", str(args.iterations)])
    summary = functools.partial(print_summary, turns, a, b)
    for name in ("gae", "discounted_returns"):
        for i, shape in enumerate(turns[0]["timing"][name]["shapes"]):
            for key in ("ms", "ms_cold", "host_us", "sync_us"):
                scale = 1e3 if key.startswith("ms") else 1.0   # all printed in us
                summary(f"{name} T={shape['T']} b={shape['b']} {key} in us",
                        lambda t: t["timing"][name]["shapes"][i][key] * scale)
    for key in ("ms", "cold_ms"):
        summary(f"empty launch {key} in us", lambda t: t["floor"][key] * 1e3)
    if args.iterations > 1:
        summary("main path env-steps/s", lambda t: t["env_steps_per_s"], "{:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
