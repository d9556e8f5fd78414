"""Run a function on W ranks of a fresh process group, one spawned process
a rank, on one host: the data-parallel tests and the card's smoke script
use it, the CLI spawns its own workers (``train.py``).

    results = spawn_ranks(fn, 2, args)      # fn(mesh, *args) on each rank

``fn`` must be importable by name (a module-level function). Each rank's
return value comes back through ``torch.save`` in a temporary directory,
in rank order. A rank that raises, or a run past ``timeout_s``, makes
``spawn_ranks`` raise after the other ranks are stopped.
"""
from __future__ import annotations

import os
import socket
import tempfile
import time
from typing import Any, Callable, List, Sequence

import torch

from harl_tpu_torch.parallel import mesh as dpmesh


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, world: int, port: int, device: str, backend: str,
               args: Sequence[Any], out_dir: str, timeout_s: float) -> None:
    from harl_tpu_torch.utils.device import resolve_device

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank)     # a card of its own
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # the ranks share the host's cores: four ranks on four H100s of one
    # 32-core host ran the weak-scaling workloads 4.5 % faster in all with
    # cores // 4 threads each than with every core each (PERF.md §5)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dev = resolve_device(dev)
    dpmesh.distributed_init(f"localhost:{port}", world, rank, backend, timeout_s)
    try:
        result = fn(dpmesh.make_mesh(dev), *args)
        if dev.type == "cuda":
            # a rank done first may leave an NCCL collective queued behind
            # the others: finish it before the group goes
            torch.cuda.synchronize(dev)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dpmesh.shutdown()


def spawn_ranks(fn: Callable, world: int, args: Sequence[Any] = (), device: str = "cpu",
                backend: str = "gloo", timeout_s: float = 300.0) -> List[Any]:
    """``fn(mesh, *args)`` on ``world`` spawned ranks; their results in
    rank order. ``device`` "cpu", "cuda" (rank k on ``cuda:k``) or
    "cuda:0" (every rank on that card, which only gloo shares)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, free_port(), device, backend, tuple(args), out_dir,
                              timeout_s),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} ranks did not finish within {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
