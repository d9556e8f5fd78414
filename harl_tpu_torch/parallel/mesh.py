"""Data parallelism over several processes (counterpart of
``harl_tpu/parallel/mesh.py``).

The JAX package shards the env axis of a runner's state over a ``dp``
device mesh and replicates everything else; GSPMD then computes what the
unsharded program computes. The port runs one process per rank instead, all
of them in one ``torch.distributed`` process group, and does by hand what
GSPMD does:

  * rank r of W steps the env columns [r·B/W, (r+1)·B/W) of the global
    ``n_rollout_threads`` B (``shard_rows``), drawing every random number
    at the global batch and keeping its own rows (``ShardedNoise``), so the
    W ranks together draw what one rank draws;
  * networks, optimizer moments, ValueNorm and the replay buffer are
    replicas: each rank sums its share of a loss over its rows and divides
    by the global count, and ``all_reduce_sum`` adds the gradients of every
    rank before the optimizer's clip and step, so every replica takes the
    same step;
  * ``gather_rows`` assembles global rows (the replay buffer's inserts,
    a checkpoint's carry) from every rank, in rank order, bit for bit.

A run over W ranks therefore equals the one-rank run at the same global
batch up to the order of float sums. The backend is NCCL when every rank
has a CUDA device of its own, gloo on the CPU and for ranks that share one
card. The collectives are ``all_reduce`` and ``broadcast``, which gloo
offers for CUDA tensors, and under NCCL ``all_gather_into_tensor``.

A run without a process group holds ``LOCAL``, the world-1 mesh whose
collectives return their inputs, so the losses, statistics and updates
have one form whatever the number of ranks.
"""
from __future__ import annotations

import datetime
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class Mesh:
    """A rank's view of the data-parallel group: ``rank`` of ``world``, on
    ``device``. With ``time_collectives`` set, every collective on a card
    is timed with CUDA events (``collective_ms``). With ``grouped`` false
    (``LOCAL``) there is no process group: one rank, whose collectives
    return their inputs."""

    def __init__(self, rank: int, world: int, device=None, grouped: bool = True):
        self.rank, self.world, self.grouped = rank, world, grouped
        self.device = None if device is None else torch.device(device)
        self.time_collectives = False
        self.calls = 0
        self._events: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    # ------------------------------------------------------------ collectives
    def _collective(self, run, on_card: bool) -> None:
        """``run()``, one collective: counted and, with ``time_collectives``
        on a card, timed with CUDA events."""
        self.calls += 1
        if not (self.time_collectives and on_card):
            run()
            return
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        run()
        end.record()
        self._events.append((start, end))

    def _all_reduce(self, flat: torch.Tensor, op=dist.ReduceOp.SUM) -> None:
        self._collective(lambda: dist.all_reduce(flat, op=op), flat.is_cuda)

    def collective_ms(self) -> float:
        """Milliseconds spent in the timed collectives since the last call."""
        if self._events:
            self._events[-1][1].synchronize()
        ms = sum(s.elapsed_time(e) for s, e in self._events)
        self._events.clear()
        return ms

    def all_reduce_sum(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every rank's sum of each tensor, in one all-reduce of one flat
        buffer per dtype; returns tensors of the inputs' shapes (without a
        group, the inputs detached)."""
        if not self.grouped:
            return [t.detach() for t in tensors]
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        for dtype, idx in _by_dtype(tensors).items():
            flat = torch.cat([tensors[i].detach().reshape(-1).to(self.device, dtype)
                              for i in idx])
            self._all_reduce(flat)
            for i, part in zip(idx, _split(flat, [tensors[i] for i in idx])):
                out[i] = part.to(tensors[i].device, tensors[i].dtype)
        return out

    def all_reduce_grads_(self, params: Sequence[torch.Tensor]) -> None:
        """Sum the parameters' gradients over the ranks in place (one
        bucket); a parameter without a gradient counts as a zero one."""
        if not self.grouped:
            return
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        for g, r in zip(grads, self.all_reduce_sum(grads)):
            g.copy_(r)

    # ------------------------------------------------------------------ rows
    def row_range(self, n: int) -> Tuple[int, int]:
        """This rank's share [lo, hi) of n rows: contiguous blocks in rank
        order, the first n mod W ranks' one shorter when W does not divide n."""
        return self.rank * n // self.world, (self.rank + 1) * n // self.world

    def shard_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a global tensor's rows (axis 0)."""
        lo, hi = self.row_range(x.shape[0])
        return x[lo:hi]

    def gather_rows(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every rank's rows, in rank order, from equal local blocks, bit
        for bit (-0.0 and NaN payloads included): the tensors travel as the
        bytes of one flat buffer, gathered into W rows by
        ``all_gather_into_tensor`` under NCCL; gloo, which gathers no CUDA
        tensors, all-reduces a zero-filled buffer of W rows in which each
        rank fills its own (exact: every byte adds zeros to one value)."""
        if not self.grouped or not tensors:
            return list(tensors)
        mine = torch.cat([_bytes(x.to(self.device)) for x in tensors])
        if dist.get_backend() == dist.Backend.NCCL:
            full = torch.empty((self.world, mine.numel()), dtype=torch.uint8, device=mine.device)
            self._collective(lambda: dist.all_gather_into_tensor(full, mine), mine.is_cuda)
        else:
            full = torch.zeros((self.world, mine.numel()), dtype=torch.uint8, device=mine.device)
            full[self.rank] = mine
            self._all_reduce(full)
        out, off = [], 0
        for x in tensors:
            nb = x.numel() * x.element_size()
            # a copy starting at offset 0, so that its bytes view as x's dtype
            part = full[:, off:off + nb].clone().reshape(-1).view(x.dtype)
            out.append(part.reshape((self.world * x.shape[0],) + tuple(x.shape[1:]))
                       .to(x.device))
            off += nb
        return out

    def replica_mismatch(self, tensors: Sequence[torch.Tensor]) -> Tuple[int, float]:
        """(elements whose bits differ from rank 0's, max |Δ| to rank 0's
        over those elements) summed and maxed over the ranks: (0, 0.0)
        where the replicas are bitwise equal, whatever their dtypes."""
        if not self.grouped:
            return 0, 0.0
        mine = [t.detach().reshape(-1).to(self.device) for t in tensors]
        flat = torch.cat([_bytes(t) for t in mine])
        values = torch.cat([t.to(torch.float64) for t in mine])
        ref, ref_values = flat.clone(), values.clone()
        dist.broadcast(ref, src=0)
        dist.broadcast(ref_values, src=0)
        differ, off = [], 0
        for t in mine:
            nb = t.numel() * t.element_size()
            # an element differs where any of its bytes does
            differ.append((flat[off:off + nb] != ref[off:off + nb])
                          .reshape(t.numel(), t.element_size()).any(dim=1))
            off += nb
        differ = torch.cat(differ)
        diff = torch.where(differ, torch.nan_to_num((values - ref_values).abs(),
                                                    nan=float("inf")), 0.0)
        (bits,) = self.all_reduce_sum([differ.sum().to(torch.float64)])
        stat = diff.max().reshape(1)
        self._all_reduce(stat, dist.ReduceOp.MAX)
        return int(bits), float(stat)


LOCAL = Mesh(0, 1, grouped=False)


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """The bytes of ``x``, flat (a view where ``x`` is contiguous)."""
    return x.detach().contiguous().reshape(-1).view(torch.uint8)


def _wire(dtype: torch.dtype) -> torch.dtype:
    """The dtype a tensor travels in: bool as uint8, the rest as they are."""
    return torch.uint8 if dtype == torch.bool else dtype


def _by_dtype(tensors: Sequence[torch.Tensor]) -> Dict[torch.dtype, List[int]]:
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(_wire(t.dtype), []).append(i)
    return groups


def _split(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    parts = torch.split(flat, [t.numel() for t in like])
    return [p.reshape(t.shape) for p, t in zip(parts, like)]


def map_tensors(fn, x):
    """``fn`` over every tensor of nested NamedTuples, tuples, lists and
    dicts (a rollout carry, a checkpoint payload's carry)."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(map_tensors(fn, v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(map_tensors(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: map_tensors(fn, v) for k, v in x.items()}
    return x


def tensors_of(x) -> List[torch.Tensor]:
    """The tensors of a nested structure, in ``map_tensors`` order."""
    found: List[torch.Tensor] = []
    map_tensors(found.append, x)
    return found


def gather_tree(mesh: Mesh, x):
    """``x`` with every tensor replaced by its global rows (one call)."""
    full = iter(mesh.gather_rows(tensors_of(x)))
    return map_tensors(lambda _: next(full), x)


def shard_tree(mesh: Mesh, x):
    """``x`` with every tensor replaced by this rank's block of rows."""
    return map_tensors(mesh.shard_rows, x)


class ShardedNoise:
    """A noise source (``utils/noise.py``) over a sharded axis of ``rows``
    global rows: each draw whose leading axis is that axis is made at the
    global size from ``base`` and cut to this rank's block, so every rank's
    generator advances as the one-rank run's does. Permutations and replay
    indices are global draws, the same on every rank. The caller names the
    axis by picking the source: the runners hold one over the env axis and
    one over the replay sample's rows."""

    def __init__(self, base, mesh: Mesh, rows: int):
        self.base, self.mesh, self.rows = base, mesh, rows
        self.local = mesh.row_range(rows)

    def _cut(self, shape: Sequence[int], draw):
        lo, hi = self.local
        if shape[0] != hi - lo:
            raise ValueError(f"a draw of {shape[0]} rows on a rank holding {hi - lo} of "
                             f"{self.rows}")
        return draw((self.rows,) + tuple(shape[1:]))[lo:hi]

    def action_noise(self, shape):
        return self._cut(shape, self.base.action_noise)

    def gumbel_noise(self, shape):
        return self._cut(shape, self.base.gumbel_noise)

    def uniform(self, shape):
        return self._cut(shape, self.base.uniform)

    def randint(self, shape, high):
        return self._cut(shape, lambda s: self.base.randint(s, high))

    def reset_noise(self, n_envs, spec):
        lo, hi = self.local
        if n_envs != hi - lo:
            raise ValueError(f"a reset of {n_envs} envs on a rank holding {hi - lo}")
        return tuple(x[lo:hi] for x in self.base.reset_noise(self.rows, spec))

    def permutation(self, n):
        return self.base.permutation(n)

    def indices(self, n, high):
        return self.base.indices(n, high)


def distributed_init(coordinator: str, world_size: int, rank: int,
                     backend: str = "gloo", timeout_s: float = 600.0) -> None:
    """Join the process group of ``world_size`` ranks at ``coordinator``
    (``host:port``, rank 0 listening there): the counterpart of
    ``jax.distributed.initialize``. ``backend`` "nccl" where every rank has
    a CUDA device of its own, "gloo" on the CPU or on a shared card."""
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def make_mesh(device) -> Mesh:
    """This process's ``Mesh`` over the initialised process group."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs distributed_init first")
    return Mesh(dist.get_rank(), dist.get_world_size(), device)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
