#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``harl_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository, on a host with one CUDA device, the CUDA
toolkit (``nvcc``) and ``nvidia-smi``. Phases, each of which raises on failure,
run in the order 1-4, 10, 5, 7, 8, 9, 11, 12, 13, 14, 15, 16, 17, 18, 19,
20, 21, 22, 23, then the torch.profiler sessions of 10, 6, 8, 16, 17 and 18: a profiler
session leaves the process slower, so every timed run comes before the
first one.

1. require CUDA and print the card's name and power limit (``nvidia-smi``);
2. build the port's CUDA sources (``harl_tpu_torch/csrc/*.cu``) with ``nvcc``,
   one process per source, all started together;
3. hold every kernel against its plain PyTorch version on the card, at the
   main path's shape, the SMACLite FP shape, T=1024, ragged shapes and inputs
   that are not 16-byte aligned (tolerance below);
4. time every kernel at the main path's shape and the SMACLite FP shape,
   with its inputs warm in L2 and cold, beside its byte/operation bound, the
   host's cost of a call, an empty launch timed the same way, and (at the
   main shape) its plain version;
5. drive the main path: HAPPO on planar HalfCheetah-6x1, 4096 envs × 32
   steps, MLP [64, 64], through ``OnPolicyRunner.train_iteration`` (3
   iterations; launch counts zeroed just before and read just after), then
   one ``use_gae: false`` iteration at 512 envs through the returns kernel;
6. profile one more main-path iteration with ``torch.profiler``: the
   device's busy share and its costliest kernels;
7. check one small iteration on the card against the same iteration on the
   CPU, from the same parameters and the same noise;
8. drive the recurrent discrete path: HAPPO on SMACLite 5m_vs_6m with the FP
   state, GRU actors and critic, 256 envs × 70 steps, MLP [64, 64, 64]
   (bench.py:257-268), 3 iterations with the launch counts zeroed just
   before and read just after; then one more iteration split into rollout
   and update, in which the GAE kernel's returns on the path's own inputs
   (T=70, b=1280) are held against the plain version and timed; last, the
   device ops of one env step and one rollout step, and one more iteration
   under torch.profiler;
9. check one small SMACLite iteration (3m, FP, GRU) on the card against the
   same iteration on the CPU: actions, availability and masks equal;
10. drive the off-policy path, right after phase 4: HASAC on planar
   HalfCheetah-6x1 at the bench's widths (bench.py:289-325: 256 envs,
   ``train_interval`` 50, batch 1000, buffer 200,000, ``n_step`` 5, MLP
   [256, 256]) through ``OffPolicyRunner``: the warmup, one collect+train
   block, 2 timed blocks (env-steps/s), one more block split into collect
   and train; last, 2 more timed blocks, the device ops of one env step
   with its actors and of one update, and one more block under
   torch.profiler; the launch counts are zeroed before each part and read
   after it (this path launches no kernel of the port);
11. check one small HASAC and one small HATD3 block (warmup, collect,
   train) on the card against the same blocks on the CPU: the buffer's rows
   and every parameter after training;
12. drive the CLI, ``harl_tpu_torch.train.main``, on the repo's tuned HATRPO
   config for SMACLite 5m_vs_6m at its full widths (20 envs x 160 steps, FP,
   GRU actors and critic, MLP [64, 64, 64]): 2 iterations with evaluation (10
   episodes) and a checkpoint, into a temporary directory outside the repo;
   the GAE kernel launched once an iteration; then a second ``main`` that
   resumes from that checkpoint (its restored parameters, and those of a
   fresh state restored from it, equal the checkpoint bitwise) and trains one
   more iteration, with HATRPO's update timed by phase; then one more
   rollout, on whose returns inputs (T=160, b=100) the GAE kernel is held
   against its plain version and timed warm;
13. drive the other CLI paths from their tuned configs without evaluation:
   MAPPO with share_param and HAA2C with linear lr decay on HalfCheetah 2x3
   (2 iterations each of 20 envs x 200 steps, and one HAA2C iteration with
   ``use_gae False`` through the returns kernel), HASAC on HalfCheetah 6x1
   (its warmup and 2 blocks);
14. check one small iteration each of HATRPO on 3m (FP, GRU), HATRPO on
   HalfCheetah 2x3 and MAPPO with share_param on HalfCheetah 2x3 on the card
   against the CPU, with HATRPO's accepted line-search fractions printed for
   both devices (and required equal);
15. drive the slice of MPE, Walker2d, Hopper and the discrete off-policy
   algorithms through the CLI on the repo's tuned configs as they are (only
   iterations or blocks cut, no eval unless stated): (a) HAPPO on MPE
   simple_spread, 2 iterations of 20 envs x 200 steps with eval at the
   25-step horizon; (b) HAPPO on Walker2d 6x1, 2 iterations of 20 x 200, at
   least one episode ending unhealthy; (c) HATD3 on Hopper 3x1, (d) discrete
   HASAC on speaker-listener (n_step 20, auto-alpha, buffer 1,000,000 rows)
   and (e) HAD3QN on discrete simple_spread, each its warmup and 2 blocks;
   each prints env-steps/s, and the GAE kernel runs once an iteration on (a)
   and (b), no kernel on (c)-(e); then (f) small discrete HASAC and HAD3QN
   blocks and a Walker2d iteration through termination on the card against
   the CPU (actions, availability, masks and bad masks equal);
16. drive the slice of SMACv2, the FP replay buffer and the 3D Ant through
   the CLI on the repo's tuned configs as they are (only iterations or
   blocks cut, no eval): (a) HAPPO on SMACv2 protoss_5_vs_5, 2 iterations of
   20 envs x 160 steps (GRU, MLP [64]), where the resets must draw both
   spawn branches and teams that differ across envs; (b) HATRPO on SMACv2
   terran_5_vs_5, 1 iteration, where a medivac must be drawn and heal; (c)
   FP HASAC on SMACLite 5m_vs_6m (n_step 20, auto-alpha, buffer 1,000,000
   rows), its warmup and 2 blocks, with the buffer's bytes on the card; (d)
   HAPPO on the Ant 4x2, 2 iterations of 20 x 200; each prints env-steps/s,
   and the GAE kernel runs once an iteration on (a), (b) and (d), no kernel
   on (c); then (e) a small SMACv2 HAPPO iteration (a reset and 20 steps),
   an FP HASAC block on 3m and an Ant iteration through unhealthy
   terminations on the card against the CPU (unit types, actions,
   availability, masks and bad masks equal); after every timed run, the
   device ops of one Ant env step;
17. drive the slice of the Bi-DexterousHands family and the 3D Humanoid
   through the CLI on the repo's tuned configs as they are (only iterations
   or blocks cut, no eval): (a) HAPPO on Humanoid 17x1, 2 iterations of 20
   envs x 200 steps, at least one episode ending unhealthy; (b) HASAC on
   HumanoidStandup 17x1 (n_step 10, buffer 1,000,000 rows), its warmup and 2
   blocks, with the buffer's bytes on the card; (c) HAPPO on ShadowHandOver,
   2 iterations of 256 envs x 75 steps, then one more rollout on whose GAE
   inputs (T=75, b=256) the kernel is held against its plain version and
   timed; (d) HASAC on ShadowHandLiftUnderarm (n_step 20, auto-alpha, buffer
   1,000,000 rows), its warmup and 2 blocks, a fingertip pushing the pot
   required; each prints env-steps/s, and the GAE kernel runs once an
   iteration on (a) and (c), no kernel on (b) and (d); then (e) a small
   Humanoid iteration through unhealthy terminations, a HumanoidStandup
   reset and steps, a TwoCatchUnderarm iteration with the objects in
   contact, a MetaMT4 reset drawing several layouts, a DoorOpenOutward HASAC
   block and an Allegro reset and steps on the card against the CPU (flags,
   layouts, masks and ``won`` equal); after every timed run, (f) the device
   ops of one Humanoid and one ShadowHandOver env step;
18. drive the slice of academy soccer, air combat and the manyagent
   swimmer through the CLI on the repo's tuned configs as they are (only
   iterations, blocks and eval episodes cut): (a) HAPPO on academy
   3_vs_1_with_keeper, 2 iterations of 1024 envs x 128 steps and an
   evaluation of 10 episodes (the config's 20 cut), with the episode ends
   counted by kind (goal, lost, out, timeout; one that is not a timeout
   required); (b) HAPPO on 2v2 air combat (MultiDiscrete(11, 11, 10)), 2
   iterations of 1024 x 128, a downed aircraft required; each then one more
   rollout on whose GAE inputs (T=128, b=1024) the kernel is held against its
   plain version and timed; (c) HASAC on manyagent_swimmer 10x2 (buffer
   1,000,000 rows), its warmup and 2 blocks, with the buffer's bytes; then
   (d) small soccer (``simple`` and ``pixels``) and air-combat HAPPO
   iterations, a MultiDiscrete HASAC block on air combat, and resets and
   steps of the swimmer, Reacher, coupled_half_cheetah and the manyagent ant
   on the card against the CPU (actions, masks, bad masks and flags equal);
   after every timed run, (e) the device ops of one env step of each new env;
19. data parallelism (``harl_tpu_torch/parallel``): the one-rank runs
   without a mesh of HalfCheetah HAPPO (4096 envs x 32, 2 iterations),
   SMACLite 5m_vs_6m FP GRU HAPPO (256 x 70, 1 iteration) and HASAC at the
   bench's widths (after the warmup and a collect: a train block, a
   collect, a train block), saving the state before each step; (a) the
   HalfCheetah run through ``run(mesh=…)`` over a world-1 NCCL group,
   bitwise equal to the run without a mesh; (b) two ranks spawned on the
   one card (gloo over CUDA tensors) on each workload, every step resumed
   from the one-rank run's state before it: the replicas bitwise equal
   after every step; on-policy, every iteration's first-step gradients of
   every optimizer (summed over the ranks) equal (rtol 1e-5, atol 1e-6)
   to the one-rank update of the very rows the ranks collected, and the
   parameters and moments within rtol 1e-5, atol 1e-5 of it (Adam carries
   the sums' rounding by lr/eps), both against the one-rank run's own
   rollout reported (at twice the width the planar physics rounds apart);
   HASAC's train blocks' first-step gradients and first critic losses
   equal to the one-rank run's, its parameters reported, its gathered
   collect bitwise equal to each rank's share replayed without a process
   group and, reported, apart from the one-rank run's wider collect by
   the width's rounding; GAE once an iteration on each rank and held against
   its plain version on that rank's columns (T=32, b=2048; T=70, b=640);
   (c) the CLI with ``--platform cpu --n_devices 2`` on a tiny MPE HAPPO
   run, and the tuned HalfCheetah-2x3 MAPPO (share_param) with
   ``--n_devices 1``; (d) small AdamW and ``xavier_normal_`` HAPPO
   iterations, ValueNorm's ``per_element_update`` and an off-policy
   ``share_param`` HATD3 block on the card against the CPU; (e)
   env-steps/s of (a), (b) and the one-rank runs, and the all-reduces and
   their milliseconds (CUDA events) a step;
20. the host-env path (``envs/host.py``) on a stand-in host env in NumPy
   with HalfCheetah-6x1's spaces (``StandInCheetah``: the card's machine
   has neither gymnasium nor mujoco, so its rates are not MuJoCo's): (a)
   HAPPO through ``OnPolicyRunner.run`` at happo.yaml's widths (20 envs x
   200 steps, MLP [128, 128], 2 iterations), with env-steps/s of the
   second, ``HostVecEnv.step``'s µs a step against the rest of a
   collection step, the update's seconds, the GAE kernel once an
   iteration, truncations and terminations in every iteration, then the
   kernel held against its plain version on one more collection's inputs
   (T=200, b=20); (b) HATD3 through ``OffPolicyRunner.run`` at hatd3.yaml's
   widths (20 envs, warmup 10,000 steps, batch 1000, buffer 1,000,000
   rows, MLP [256, 256]), 2 blocks, with env-steps/s, the buffer's GiB and
   every inserted row counted; (c) a small HAPPO GRU iteration on the
   Discrete stand-in and a small HATD3 block on the card against the CPU
   (actions, availability, masks and bad masks equal);
21. learning parity: ``scripts/torch_learning_parity.py`` on one of its
   runs, the tuned academy pass_and_shoot_with_keeper HAPPO at its widths
   (256 envs x 200 steps, GRU), seed 1, cut to 2 iterations and the
   evaluation at the last: the GAE kernel launched once an iteration, its
   error on the run's own inputs (T=200, b=256) within 1e-5 of the largest
   return, the score-rate curve and the run's record written.
22. several cards, on this one: ``scripts/torch_multicard.py``'s legs
   (its ``smoke_phase``), (a) on one rank over a world-1 NCCL group: leg 1,
   the four program shapes of the JAX package's ``dryrun_multichip`` at B=2
   (HAPPO MLP and FP GRU, HASAC's warmup, collect and train, MAPPO
   share_param), held as phase 19 (b) holds its steps; leg 3, the weak
   scaling run at a rank's widths cut to one warm-up and one timed step
   (HASAC its warmup and one block), in one threads mode and not
   profiled; leg 4, the all-reduce latencies of one element, a HalfCheetah
   actor's gradients and a HASAC critic's (median of 100); (b) on 4 gloo
   ranks sharing the card: leg 1 at B=8 and leg 2 cut to one iteration of
   HalfCheetah (1024 envs a rank) and of SMACLite FP (64 a rank), held as
   phase 19 (b), GAE held against its plain version on each rank's columns
   (T=32, b=1024; T=70, b=320). NCCL between cards is the script's own
   run on four.
23. a replay ring of the largest kind: the tuned 8m_vs_9m FP HASAC
   config's runner (``REPLAY_MAP``) with its whole 1,000,000-row ring
   (29.9 GiB; with 10m_vs_11m's 49.1 GiB ring the phase took 200.7 s and
   the whole script 1,037 s of its 1,200 on an H100 host, so
   ``scripts/torch_replay_scale.py`` restores that ring and MMM2's), its
   bytes predicted (``ring_nbytes``) and refused with the card's free
   memory less; a warmup cut to 1,000 env-steps and one block; a
   checkpoint written to a memory file (after checking that the host has
   the memory for it: the card's host caps a run's disk writes at 45 GiB,
   and the earlier phases' off-policy runs write checkpoints of their rings
   there, ~29 GiB by ``ring_nbytes``), one more
   collect block, then the checkpoint restored in place by the runner's
   ``restore`` (``measured_restore``) with the card filled but for 4 GiB,
   so that the old restore's second ring could not land: the ring's
   tensors keep their storage, the peak device memory during the restore
   (the ballast aside) stays below the ring plus 4 GiB, and every column
   equals the file's bytes in 1 GiB chunks. Then 1 GiB of the file is
   copied onto the card straight and through the restore's pinned stages,
   each timed; the memory file is closed.
24. tuned HASAC HalfCheetah-6x1 at a late state, the card against the CPU:
   its config's runner (20 envs, [256, 256] with feature normalisation,
   batch 1000, ``n_step`` 10, auto-α, a 1,000,000-row ring) after a
   warmup of 4,000 env-steps (each env's step counter set first so that
   every env crosses a 1,000-step truncation in it) and one update, set to
   what a long run reaches
   (``set_late``: a ring of 410,000 rows, the warmup's rows repeated whole;
   every Adam count 20,000; every log α −6; each env's step counter set
   so that every env is truncated and reset once in the first 40 held
   steps), copied whole to a CPU runner of the same config; then 50
   collect steps and 50 updates on the card,
   each held against the CPU's from the card's state (carry and cursor
   before each step, the rows it inserted after it; networks, optimizers
   and α before each update) and the card's own draws: inserted rows,
   collect metrics, carry, critic loss, and every parameter, target, Adam
   moment and log α at the tolerances ``LATE_*`` states. A fault that only
   the card's arithmetic or a CUDA-only branch takes shows here, which
   the CPU witness (``scripts/torch_offpolicy_witness.py``) cannot see.

It prints one JSON line about the kernels, the ``nvidia-smi`` line, and as
its last line ``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import gc
import json
import math
import os
import statistics
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, NamedTuple

import numpy as np
import torch

# Kernel against plain version: both are float32; nvcc contracts a*b+c into
# fused multiply-adds where the plain version rounds twice, so the two differ
# in the last bits, and the difference grows with T through the carry.
KERNEL_RTOL = 1e-5
KERNEL_ATOL = 1e-5
# The small end-to-end iteration, card against CPU: the physics and the
# updates reduce in another order on the two devices (f32), and the rollout
# compounds that over T·frame_skip substeps.
E2E_RTOL = 1e-3
E2E_ATOL = 1e-4

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s, 67 TFLOP/s float32 outside
# the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

MAIN = dict(n_envs=4096, episode_length=32, hidden=[64, 64], iterations=3)
# the JAX package's recurrent bench configuration (bench.py:257-268)
SMAC = dict(map_name="5m_vs_6m", n_envs=256, episode_length=70, hidden=[64, 64, 64],
            data_chunk_length=10, iterations=3)
RETURNS_ENVS = 512
# (label, T, trailing) of the timed kernel shapes: the main path's, and the
# SMACLite 5m_vs_6m FP critic's (bench.py:257, 268: 256 envs x 5 agents, T=70)
TIMED_SHAPES = (("main", MAIN["episode_length"], (MAIN["n_envs"], 1)),
                ("smaclite_fp", 70, (256, 5, 1)))
# the JAX package's off-policy bench configuration (bench.py:289-325)
HASAC = dict(n_envs=256, episode_limit=1000, warmup_steps=256 * 4, train_interval=50,
             n_step=5, batch_size=1000, buffer_size=200_000, hidden=[256, 256],
             timed_blocks=2)
# Zeroing this many bytes between launches evicts the 50 MB L2.
FLUSH_BYTES = 256 * 2 ** 20


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------- build
def build_all() -> None:
    from harl_tpu_torch.ops import _build

    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        paths = list(pool.map(lambda n: _build.build(n, verbose=True), names))
    log(f"built {names} in {time.perf_counter() - t0:.2f} s: {[p.name for p in paths]}")


# ------------------------------------------------------------- kernel checks
def returns_problem(T: int, trailing, with_bad: bool, seed: int, device, offset: int = 0):
    """Inputs of the recursions; ``offset`` floats into their storage (1:
    contiguous but not 16-byte aligned)."""
    g = torch.Generator().manual_seed(seed)
    shape = (T,) + tuple(trailing)
    shape1 = (T + 1,) + tuple(trailing)
    rewards = torch.randn(shape, generator=g)
    values = torch.randn(shape1, generator=g)
    masks = (torch.rand(shape1, generator=g) > 0.15).float()
    bad = (torch.rand(shape1, generator=g) > 0.1).float() if with_bad else None

    def to(x):
        if x is None:
            return None
        view = torch.empty(x.numel() + offset, device=device)[offset:].view(x.shape)
        return view.copy_(x)

    return to(rewards), to(values), to(masks), to(bad)


def kernel_cases():
    """(name, kernel, plain, args builder) for every kernel of the path."""
    from harl_tpu_torch.ops import gae_kernels as K

    gamma, lam = 0.99, 0.95

    def gae_args(r, v, m, b):
        return (r, v, m, b, gamma, lam)

    def ret_args(r, v, m, b):
        return (r, v, m, b, v[-1].contiguous(), gamma)

    return [
        ("gae", K.gae, K.gae_reference, gae_args, "harl_tpu/ops/pallas_gae.py:114"),
        ("discounted_returns", K.discounted_returns, K.discounted_returns_reference,
         ret_args, "harl_tpu/ops/pallas_gae.py:150"),
    ]


def check_kernels(device) -> dict:
    """Kernel against plain version at the main path's shape and ragged ones;
    returns the largest abs error per kernel at the main path's shape."""
    main_shape = (MAIN["episode_length"], (MAIN["n_envs"], 1), 0)
    # (T, trailing, storage offset): the timed shapes, T=1024 over many ring
    # stages, happo.yaml's defaults, ragged column tiles, misaligned inputs
    shapes = [main_shape, (70, (256, 5, 1), 0), (1024, (4096, 1), 0), (200, (20, 1), 0),
              (33, (1, 1), 0), (40, (4100, 1), 0), (24, (3000, 1), 0), (9, (7, 1), 0),
              (9, (4, 3, 1), 0),
              (9, (130, 1), 0), (9, (5000, 1), 0), (1, (1, 1), 0),
              (MAIN["episode_length"], (MAIN["n_envs"], 1), 1), (70, (256, 5, 1), 1)]
    errs = {}
    for name, kern, plain, mk, _ in kernel_cases():
        for T, trailing, offset in shapes:
            for with_bad in (True, False):
                args = mk(*returns_problem(T, trailing, with_bad, seed=T + len(trailing),
                                           device=device, offset=offset))
                out = kern(*args)
                torch.cuda.synchronize()
                ref = plain(*args)
                torch.testing.assert_close(out, ref, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
                if (T, trailing, offset) == main_shape:
                    err = (out - ref).abs().max().item()
                    errs[name] = max(errs.get(name, 0.0), err)
        log(f"{name}: kernel == plain on {len(shapes) * 2} cases "
            f"(rtol {KERNEL_RTOL}, atol {KERNEL_ATOL}); main-shape max |err| {errs[name]:.3g}")
    return errs


def time_warm(fn, reps: int) -> tuple:
    """(device ms a call, host µs to issue a call, µs a call with a sync).

    Device time: ``reps`` calls queued behind a spin kernel, between two
    CUDA events, so the host's cost of issuing them is hidden and the calls
    run back to back with their inputs in L2; median of 5 rounds. Issue
    time: the host's clock around the same ``reps`` calls, median of the 5
    rounds. With a sync: one call at a time from an idle card, launch
    latency and ``torch.cuda.synchronize()`` included; median of ``reps``.
    """
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    device, issue, synced = [], [], []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(3e9 * host_s) + 1000)  # ~1.5x the issue time at <= 2 GHz
        a.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        issue.append((time.perf_counter() - t0) / reps * 1e6)
        b.record()
        b.synchronize()
        device.append(a.elapsed_time(b) / reps)
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        synced.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(device), statistics.median(issue), statistics.median(synced)


def time_cold(fn, reps: int, flush: torch.Tensor) -> float:
    """Device ms of one call whose inputs are not in L2: before each call,
    ``flush`` (larger than the L2) is zeroed; a pair of CUDA events around
    the call alone keeps the flush out of the time. The zeroing takes longer
    on the card than a call takes to issue, so the calls run from a full
    queue, as in ``time_warm``. Median of ``reps`` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(int(1e6))
    for a, b in events:
        flush.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def bound_ms(name: str, T: int, b: int) -> tuple:
    """Least time for the work at (T, b) with bad masks: every float the
    recursion needs read once (rewards, masks and bad masks rows 1..T, T·b
    each; values (T+1)·b for GAE, rows 0..T-1 and next_value b for the
    returns) and the output T·b written once; against ~8 float32 operations
    per element."""
    floats = (5 * T + 1) * b
    t_bytes = floats * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = 8 * T * b / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels(device, timed_shapes=TIMED_SHAPES) -> tuple:
    """Per kernel: warm and cold device time at each (label, T, trailing) of
    ``timed_shapes``, the bound and its share, host µs a call, and the plain
    version at the first shape; and the floor: an empty launch
    (``torch.cuda._sleep(1)``) timed the same two ways."""
    from harl_tpu_torch.ops import gae_kernels as K

    flush = torch.empty(FLUSH_BYTES // 4, device=device)
    empty = lambda: torch.cuda._sleep(1)
    floor = dict(ms=time_warm(empty, reps=200)[0], cold_ms=time_cold(empty, 50, flush))
    print(f"empty launch: {floor['ms'] * 1e3:.2f} us back to back, {floor['cold_ms'] * 1e3:.2f} "
          f"us alone after an L2 flush (the floor of any single launch)", flush=True)
    res = {}
    for name, kern, plain, mk, _ in kernel_cases():
        before = getattr(K, name).launches
        shapes = []
        for label, T, trailing in timed_shapes:
            b = math.prod(trailing)
            args = mk(*returns_problem(T, trailing, True, seed=7, device=device))
            ms, host_us, sync_us = time_warm(lambda: kern(*args), reps=200)
            ms_cold = time_cold(lambda: kern(*args), 50, flush)
            bms, by = bound_ms(name, T, b)
            shapes.append(dict(shape=label, T=T, b=b, ms=ms, ms_cold=ms_cold, bound_ms=bms,
                               bound_by=by, share=bms / ms, share_cold=bms / ms_cold,
                               host_us=host_us, sync_us=sync_us))
            print(f"{name} at T={T}, b={b} ({label}): {ms * 1e3:.3f} us warm, "
                  f"{ms_cold * 1e3:.3f} us cold on the device; bound {bms * 1e3:.3f} us ({by}), "
                  f"share {bms / ms:.3f} warm, {bms / ms_cold:.3f} cold; host {host_us:.2f} us "
                  f"to issue a call, {sync_us:.2f} us a call with a sync", flush=True)
            if len(shapes) == 1:
                plain_ms = time_warm(lambda: plain(*args), reps=20)[0]
        getattr(K, name).launches = before  # timing launches are not the main path's
        main = shapes[0]
        res[name] = dict(ms=main["ms"], plain_ms=plain_ms, bound_ms=main["bound_ms"],
                         bound_by=main["bound_by"], shapes=shapes)
        print(f"{name} plain version at T={main['T']}, b={main['b']}: {plain_ms * 1e3:.1f} us; "
              f"no single PyTorch op computes the recurrence", flush=True)
    return res, floor


# ------------------------------------------------------------- the main path
def make_runner(n_envs: int, T: int, hidden, device, use_gae: bool = True, noise=None,
                episode_limit: int = 1000):
    from harl_tpu_torch.runners.on_policy import OnPolicyRunner
    from harl_tpu_torch.utils.config_tools import get_defaults_yaml_args

    algo_args, env_args = get_defaults_yaml_args("happo", "mamujoco_jax")
    algo_args["train"].update(n_rollout_threads=n_envs, episode_length=T,
                              num_env_steps=10 ** 9)
    algo_args["model"].update(hidden_sizes=list(hidden))
    algo_args["algo"].update(use_gae=use_gae)
    env_args.update(scenario="HalfCheetah-v2", agent_conf="6x1", episode_limit=episode_limit)
    return OnPolicyRunner({"algo": "happo", "env": "mamujoco_jax"}, algo_args, env_args,
                          device=device, noise=noise)


def check_metrics(metrics, n_agents: int) -> None:
    stats = metrics["actor_stats"]
    if tuple(stats.shape) != (n_agents, 4):
        raise AssertionError(f"actor_stats shape {tuple(stats.shape)}")
    for k in ("value_loss", "critic_grad_norm", "mean_step_reward"):
        if not math.isfinite(float(metrics[k])):
            raise AssertionError(f"{k} is not finite: {float(metrics[k])}")
    if not bool(torch.isfinite(stats).all()):
        raise AssertionError(f"actor stats not finite: {stats.tolist()}")


def profile_iteration(runner, state, card: str, plain_iteration_s: float,
                      label: str = "main path", fn=None) -> None:
    """One more iteration (or ``fn()``) under torch.profiler: kernels
    launched, device busy time (the sum of kernel and copy times: one stream,
    no overlap), and the busy share against an unprofiled iteration's wall
    time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if fn is None:
            runner.train_iteration(state)
        else:
            fn()
        torch.cuda.synchronize()
    by_name, annotated = device_rows(prof)
    rows = [(us, count, key) for key, (us, count) in by_name.items()]
    busy_s = sum(r[0] for r in rows) / 1e6
    if not rows:
        print(f"profile ({label}): no device time recorded by torch.profiler on {card}",
              flush=True)
        return
    launches = sum(r[1] for r in rows)
    print(f"profile of one {label} iteration: {launches} device ops, device busy "
          f"{busy_s:.4f} s (kernels and copies; {annotated / 1e6:.4f} s of annotation spans "
          f"left out), busy share {busy_s / plain_iteration_s:.4f} of an unprofiled "
          f"iteration ({plain_iteration_s:.4f} s) on {card}", flush=True)
    for us, count, key in sorted(rows, reverse=True)[:12]:
        print(f"  {us / 1e3:10.3f} ms {count:7d}x  {key[:90]}", flush=True)


def drive_main_path(card: str) -> tuple:
    """The main path; returns (launches per kernel, a function that profiles
    one more iteration, for ``main`` to call after every timed run)."""
    from harl_tpu_torch.ops import gae_kernels as K

    n, T = MAIN["n_envs"], MAIN["episode_length"]
    runner = make_runner(n, T, MAIN["hidden"], "cuda")
    state = runner.init_state(0)
    torch.cuda.synchronize()
    K.gae.launches = 0
    K.discounted_returns.launches = 0
    times = []
    for i in range(MAIN["iterations"]):
        t0 = time.perf_counter()
        state, metrics = runner.train_iteration(state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check_metrics(metrics, runner.n_agents)
        if K.gae.launches != i + 1:
            raise AssertionError(f"gae launched {K.gae.launches} times after {i + 1} iterations")
        log(f"iteration {i + 1}: {times[-1]:.3f} s, value_loss {float(metrics['value_loss']):.4f}, "
            f"mean_step_reward {float(metrics['mean_step_reward']):.4f}")
    launches = {"gae": K.gae.launches}
    if K.discounted_returns.launches != 0:
        raise AssertionError("the GAE path launched the returns kernel")
    steps_per_s = 2 * n * T / sum(times[1:])
    print(f"main path: HAPPO HalfCheetah-6x1, {n} envs x {T} steps, MLP {MAIN['hidden']}: "
          f"{steps_per_s:.1f} env-steps/s over iterations 2-3 "
          f"({times[1]:.4f} s, {times[2]:.4f} s per iteration; first {times[0]:.4f} s) "
          f"on {card}", flush=True)

    # the same runner's phases, timed apart on one more iteration
    first_masks0 = state.carry.masks[:, 0]
    t0 = time.perf_counter()
    data = runner.rollout(state)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    runner.update_phase(state, data, first_masks0, state.carry.share_obs)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"phases of one iteration: rollout {t1 - t0:.4f} s, update {t2 - t1:.4f} s "
          f"on {card}", flush=True)
    profile = functools.partial(profile_iteration, runner, state, card, times[-1])

    # use_gae: false goes through the discounted-returns kernel
    runner = make_runner(RETURNS_ENVS, T, MAIN["hidden"], "cuda", use_gae=False)
    state = runner.init_state(1)
    torch.cuda.synchronize()
    K.gae.launches = 0
    K.discounted_returns.launches = 0
    state, metrics = runner.train_iteration(state)
    torch.cuda.synchronize()
    check_metrics(metrics, runner.n_agents)
    launches["discounted_returns"] = K.discounted_returns.launches
    if K.discounted_returns.launches != 1 or K.gae.launches != 0:
        raise AssertionError(f"use_gae=false: returns kernel {K.discounted_returns.launches}, "
                             f"gae {K.gae.launches} launches")
    log(f"use_gae=false at {RETURNS_ENVS} envs: value_loss {float(metrics['value_loss']):.4f}")
    return launches, profile


def make_smaclite_runner(n_envs: int, T: int, hidden, device, noise=None,
                         map_name: str = SMAC["map_name"],
                         data_chunk_length: int = SMAC["data_chunk_length"],
                         episode_limit=None):
    from harl_tpu_torch.runners.on_policy import OnPolicyRunner
    from harl_tpu_torch.utils.config_tools import get_defaults_yaml_args

    algo_args, env_args = get_defaults_yaml_args("happo", "smaclite")
    algo_args["train"].update(n_rollout_threads=n_envs, episode_length=T,
                              num_env_steps=10 ** 9)
    algo_args["model"].update(hidden_sizes=list(hidden), use_recurrent_policy=True,
                              recurrent_n=1, data_chunk_length=data_chunk_length)
    env_args.update(map_name=map_name, state_type="FP")
    if episode_limit:
        env_args["episode_limit"] = episode_limit
    return OnPolicyRunner({"algo": "happo", "env": "smaclite"}, algo_args, env_args,
                          device=device, noise=noise)


def device_rows(prof) -> tuple:
    """({name: [device µs, launches]} of the kernels and copies a profile
    recorded, device µs of the user annotations left out). An annotation
    (``Optimizer.step#Adam.step``) spans its kernels and the gaps between
    them on the device, so counting it would count busy time twice."""
    from torch.autograd import DeviceType

    rows, annotated = {}, 0.0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:   # CPU ops also carry their kernels' time
            continue
        us = ev.time_range.elapsed_us()
        if getattr(ev, "is_user_annotation", False):
            annotated += us
            continue
        row = rows.setdefault(ev.name, [0.0, 0])
        row[0] += us
        row[1] += 1
    return rows, annotated


def count_device_ops(fn) -> tuple:
    """(device ops, device ms) of one call of ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows, _ = device_rows(prof)
    return sum(r[1] for r in rows.values()), sum(r[0] for r in rows.values()) / 1e3


def drive_smaclite_path(card: str, device="cuda") -> tuple:
    """The recurrent discrete path at the bench's widths; returns (launches
    per kernel, the GAE kernel's shape, max |err| and warm ms on the path's
    own inputs, a function that counts the device ops of a step and profiles
    one more iteration, for ``main`` to call after every timed run)."""
    from harl_tpu_torch.ops import gae_kernels as K

    n, T = SMAC["n_envs"], SMAC["episode_length"]
    runner = make_smaclite_runner(n, T, SMAC["hidden"], device)
    state = runner.init_state(0)
    torch.cuda.synchronize()
    K.gae.launches = 0
    K.discounted_returns.launches = 0
    times = []
    for i in range(SMAC["iterations"]):
        t0 = time.perf_counter()
        state, metrics = runner.train_iteration(state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check_metrics(metrics, runner.n_agents)
        if K.gae.launches != i + 1:
            raise AssertionError(f"gae launched {K.gae.launches} times after {i + 1} iterations")
        sums = {k: float(v) for k, v in metrics["episode_metric_sums"].items()}
        log(f"smaclite iteration {i + 1}: {times[-1]:.3f} s, value_loss "
            f"{float(metrics['value_loss']):.4f}, episodes {float(metrics['episode_count']):.0f}, "
            f"metric sums {sums}")
    launches = {"gae": K.gae.launches, "discounted_returns": K.discounted_returns.launches}
    if launches["discounted_returns"] != 0:
        raise AssertionError("the SMACLite GAE path launched the returns kernel")
    steps_per_s = 2 * n * T / sum(times[1:])
    print(f"smaclite path: HAPPO SMACLite {SMAC['map_name']} FP, GRU actors and critic, "
          f"{n} envs x {T} steps, MLP {SMAC['hidden']}, chunks of {SMAC['data_chunk_length']}: "
          f"{steps_per_s:.1f} env-steps/s over iterations 2-3 ({times[1]:.4f} s, "
          f"{times[2]:.4f} s per iteration; first {times[0]:.4f} s); gae launched "
          f"{launches['gae']} times (once an iteration) on {card}", flush=True)

    # one more iteration, rollout and update timed apart; in between, the
    # GAE kernel on this iteration's own inputs against the plain version
    first_masks0 = state.carry.masks[:, 0]
    t0 = time.perf_counter()
    data = runner.rollout(state)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    c = state.carry
    last = (c.share_obs, c.masks, c.critic_rnn)
    rewards, values, masks, bad = (
        None if x is None else x.contiguous()
        for x in runner.returns_inputs(state, data, first_masks0, *last))
    if tuple(rewards.shape) != (T, n, runner.n_agents, 1):
        raise AssertionError(f"GAE inputs of shape {tuple(rewards.shape)}")
    args = (rewards, values, masks, bad, runner.gamma, runner.gae_lambda)
    before = K.gae.launches
    out = K.gae(*args)
    torch.cuda.synchronize()
    ref = K.gae_reference(*args)
    torch.testing.assert_close(out, ref, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    err = (out - ref).abs().max().item()
    ms = time_warm(lambda: K.gae(*args), reps=200)[0]
    K.gae.launches = before
    print(f"gae on the smaclite path's own inputs (T={T}, b={rewards.numel() // T}): kernel == "
          f"plain (max |err| {err:.3g}, rtol {KERNEL_RTOL}, atol {KERNEL_ATOL}); "
          f"{ms * 1e3:.3f} us warm on the device on {card}", flush=True)
    t2 = time.perf_counter()
    runner.update_phase(state, data, first_masks0, *last)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    print(f"smaclite phases of one iteration: rollout {t1 - t0:.4f} s, update {t3 - t2:.4f} s "
          f"on {card}", flush=True)

    def profile():
        # device ops of one env step (auto-reset included) and one rollout step
        actions = torch.randint(0, runner.env.n_actions, (n, runner.n_agents, 1), device=device)
        env_ops, env_ms = count_device_ops(
            lambda: runner.vec.step(state.carry.env_state, actions, runner.noise))
        reset_ops, reset_ms = count_device_ops(lambda: runner.vec.reset(runner.noise))
        with torch.no_grad():
            step_ops, step_ms = count_device_ops(lambda: runner.rollout_step(state, state.carry))
        print(f"smaclite device ops: one env step with auto-reset {env_ops} ops, {env_ms:.3f} "
              f"ms device time (its reset alone {reset_ops} ops, {reset_ms:.3f} ms); one rollout "
              f"step {step_ops} ops, {step_ms:.3f} ms, on {card}", flush=True)
        profile_iteration(runner, state, card, times[-1], label="smaclite")

    return launches, dict(T=T, b=rewards.numel() // T, ms=ms, max_abs_err=err), profile


def check_smaclite_against_cpu(devices=("cpu", "cuda"), map_name: str = "3m",
                               T: int = 10) -> None:
    """One small SMACLite iteration (``map_name``, FP, GRU, 8 envs x ``T``
    steps, episodes of 8 steps) on the card and on the CPU from the same
    parameters and the same noise (drawn on the CPU): on a SMACv2 map the
    unit types of every reset equal too."""
    from harl_tpu_torch.utils.noise import GeneratorNoise

    runs, outs = [], []
    for dev in devices:
        noise = GeneratorNoise(torch.Generator().manual_seed(4), dev)
        runner = make_smaclite_runner(8, T, [16, 16], dev, noise=noise, map_name=map_name,
                                      data_chunk_length=5, episode_limit=8)
        state = runner.init_state(0)
        if runs:   # the card's runner starts from the CPU runner's parameters
            cpu_state = runs[0][0]
            for a, b in zip(state.actors + [state.critic], cpu_state.actors + [cpu_state.critic]):
                a.net.load_state_dict(b.net.state_dict())
        runs.append((state, runner))
    for state, runner in runs:
        first_masks0 = state.carry.masks[:, 0]
        data = runner.rollout(state)
        c = state.carry
        metrics = runner.update_phase(state, data, first_masks0, c.share_obs, c.masks,
                                      c.critic_rnn)
        outs.append((state, data, metrics))
    torch.cuda.synchronize()
    (s_cpu, d_cpu, m_cpu), (s_gpu, d_gpu, m_gpu) = outs
    close = lambda a, b: torch.testing.assert_close(
        torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu(), rtol=E2E_RTOL, atol=E2E_ATOL)
    for k in ("avail", "masks", "active_masks", "next_masks", "next_bad_masks"):
        if not torch.equal(d_gpu[k].cpu(), d_cpu[k]):
            raise AssertionError(f"smaclite {map_name} {k}: card != CPU")
    for a, b in zip(d_gpu["actions"], d_cpu["actions"]):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"smaclite {map_name} actions: card != CPU")
    types = [(s.carry.env_state.ally_type, s.carry.env_state.enemy_type) for s in (s_cpu, s_gpu)]
    if not all(torch.equal(a, b.cpu()) for a, b in zip(*types)):
        raise AssertionError(f"smaclite {map_name} unit types: card != CPU")
    for k in ("obs", "share_obs", "value", "reward", "critic_rnn"):
        close(d_gpu[k], d_cpu[k])
    for k in ("value_loss", "critic_grad_norm", "mean_step_reward", "episode_return_sum"):
        close(m_gpu[k], m_cpu[k])
    close(m_gpu["actor_stats"], m_cpu["actor_stats"])
    for a, b in zip(s_gpu.actors + [s_gpu.critic], s_cpu.actors + [s_cpu.critic]):
        for va, vb in zip(a.net.state_dict().values(), b.net.state_dict().values()):
            close(va, vb)
    log(f"small SMACLite {map_name} iteration ({T} steps): card == CPU (actions, availability, "
        f"masks and unit types equal; floats at rtol {E2E_RTOL}, atol {E2E_ATOL}); "
        f"{float(d_cpu['emitted_cnt'].sum()):.0f} episodes ended")


def check_against_cpu(devices=("cpu", "cuda")) -> None:
    """One small iteration on the card and on the CPU from the same
    parameters and the same noise (drawn on the CPU for both)."""
    from harl_tpu_torch.utils.noise import GeneratorNoise

    runs = []
    for dev in devices:
        noise = GeneratorNoise(torch.Generator().manual_seed(3), dev)
        runner = make_runner(16, 8, [16, 16], dev, noise=noise, episode_limit=5)
        state = runner.init_state(0)
        if runs:   # the card's runner starts from the CPU runner's parameters
            cpu_state = runs[0][0]
            for a, b in zip(state.actors + [state.critic], cpu_state.actors + [cpu_state.critic]):
                a.net.load_state_dict(b.net.state_dict())
        runs.append((state, runner))
    out = [runner.train_iteration(state) for state, runner in runs]
    torch.cuda.synchronize()
    (s_cpu, m_cpu), (s_gpu, m_gpu) = out
    close = lambda a, b: torch.testing.assert_close(
        torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu(), rtol=E2E_RTOL, atol=E2E_ATOL)
    for k in ("value_loss", "critic_grad_norm", "mean_step_reward", "episode_return_sum"):
        close(m_gpu[k], m_cpu[k])
    close(m_gpu["actor_stats"], m_cpu["actor_stats"])
    for a, b in zip(s_gpu.actors + [s_gpu.critic], s_cpu.actors + [s_cpu.critic]):
        for va, vb in zip(a.net.state_dict().values(), b.net.state_dict().values()):
            close(va, vb)
    close(s_gpu.carry.obs, s_cpu.carry.obs)
    log(f"small iteration: card == CPU (rtol {E2E_RTOL}, atol {E2E_ATOL})")


def make_off_policy_runner(algo: str, device, noise=None, **overrides):
    """An off-policy runner on HalfCheetah-6x1 with ``HASAC``'s settings
    unless ``overrides`` says otherwise (``n_step=None``: the YAML's)."""
    from harl_tpu_torch.runners.off_policy import OffPolicyRunner
    from harl_tpu_torch.utils.config_tools import get_defaults_yaml_args

    c = {**HASAC, **overrides}
    algo_args, env_args = get_defaults_yaml_args(algo, "mamujoco_jax")
    algo_args["train"].update(n_rollout_threads=c["n_envs"], num_env_steps=10 ** 9,
                              warmup_steps=c["warmup_steps"],
                              train_interval=c["train_interval"], update_per_train=1)
    algo_args["algo"].update(batch_size=c["batch_size"], buffer_size=c["buffer_size"])
    if c["n_step"] is not None:
        algo_args["algo"]["n_step"] = c["n_step"]
    algo_args["model"].update(hidden_sizes=list(c["hidden"]))
    env_args.update(scenario="HalfCheetah-v2", agent_conf="6x1",
                    episode_limit=c["episode_limit"])
    return OffPolicyRunner({"algo": algo, "env": "mamujoco_jax"}, algo_args, env_args,
                           device=device, noise=noise)


def steal_s() -> float:
    """CPU seconds the hypervisor gave to other guests, summed over this
    machine's cores (the ``steal`` column of /proc/stat); nan without it."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return math.nan


def drive_hasac_path(card: str, device="cuda") -> tuple:
    """HASAC at the bench's widths. ``main`` runs it before any torch.profiler
    session of the process. Returns (launches per kernel, a function that
    ``main`` calls after every other timed run: one more round of timed
    blocks, the op counts and a profiled block, and that returns the
    launches of that part). The second round tells a process that slows
    with age from a fresh one.
    Each timed block also reads the process's CPU time and the machine's
    steal time, to tell work in the process from a host that gives it less
    of its cores. None of the port's kernels is on this path."""
    from harl_tpu_torch.ops import gae_kernels as K

    n, interval = HASAC["n_envs"], HASAC["train_interval"]
    runner = make_off_policy_runner("hasac", device)
    state = runner.init_state(0)
    torch.cuda.synchronize()
    K.gae.launches = 0
    K.discounted_returns.launches = 0
    t0 = time.perf_counter()
    state = runner.warmup_block(state)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    rows, updates = HASAC["warmup_steps"], 0

    def block():
        nonlocal state, rows, updates
        state, cm = runner.collect_block(state)
        state, tm = runner.train_block(state)
        rows += interval * n
        updates += interval
        return cm, tm

    def timed_round(label: str, blocks: int) -> list:
        """(wall s, process CPU s, steal s) of each of ``blocks`` blocks."""
        out = []
        for i in range(blocks):
            t0, c0, s0 = time.perf_counter(), time.process_time(), steal_s()
            cm, tm = block()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0, time.process_time() - c0, steal_s() - s0))
            loss = float(tm["critic_loss"])
            if not math.isfinite(loss):
                raise AssertionError(f"critic_loss is not finite: {loss}")
            log(f"hasac block {i + 1} {label}: {out[-1][0]:.3f} s, critic_loss {loss:.4f}, "
                f"episodes {float(cm['episode_count']):.0f}, mean_step_reward "
                f"{float(cm['mean_step_reward']):.4f}")
        print(f"hasac blocks {label}: {len(out) * interval * n / sum(t[0] for t in out):.1f} "
              f"env-steps/s; s per block {', '.join(f'{t[0]:.4f}' for t in out)}; process CPU "
              f"s {', '.join(f'{t[1]:.4f}' for t in out)}; steal s (all cores) "
              f"{', '.join(f'{t[2]:.4f}' for t in out)} on {card}", flush=True)
        return out

    first = timed_round("warm-up", 1)
    fresh = timed_round("in a fresh process", HASAC["timed_blocks"])
    print(f"hasac path: HASAC HalfCheetah-6x1, {n} envs, train_interval {interval}, batch "
          f"{HASAC['batch_size']}, buffer {HASAC['buffer_size']}, n_step {HASAC['n_step']}, "
          f"MLP {HASAC['hidden']}: {len(fresh) * interval * n / sum(t[0] for t in fresh):.1f} "
          f"env-steps/s over blocks 2-{1 + len(fresh)}, before any profiler session "
          f"(first block {first[0][0]:.4f} s; warmup {warmup_s:.4f} s) on {card}", flush=True)

    # one more block, collect and train timed apart
    t0 = time.perf_counter()
    state, _ = runner.collect_block(state)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, tm = runner.train_block(state)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rows += interval * n
    updates += interval
    print(f"hasac phases of one block: collect {t1 - t0:.4f} s ({interval} env steps), train "
          f"{t2 - t1:.4f} s ({interval} updates) on {card}", flush=True)
    launches = {"gae": K.gae.launches, "discounted_returns": K.discounted_returns.launches}

    def profile() -> dict:
        nonlocal rows, updates
        K.gae.launches = 0
        K.discounted_returns.launches = 0
        timed_round("after the other paths, before the profiler", HASAC["timed_blocks"])

        # device ops of one env step with its actors, and of one update
        def env_step():
            with torch.no_grad():
                runner._env_step_insert(state, *runner._env_actions(state.actors, state.carry))

        step_ops, step_ms = count_device_ops(env_step)
        update_ops, update_ms = count_device_ops(lambda: runner.update(state))
        rows += n
        updates += 1
        print(f"hasac device ops: one env step with its 6 actors and the insert {step_ops} ops, "
              f"{step_ms:.3f} ms device time; one update (sample, critic, 6 sequential actors, "
              f"targets) {update_ops} ops, {update_ms:.3f} ms, on {card}", flush=True)
        profile_iteration(runner, state, card, statistics.median(t[0] for t in fresh),
                          label="hasac block", fn=block)
        later = {"gae": K.gae.launches, "discounted_returns": K.discounted_returns.launches}
        if state.buffer.cur_size != rows or state.total_it != updates:
            raise AssertionError(f"buffer holds {state.buffer.cur_size} rows (expected {rows}), "
                                 f"{state.total_it} updates (expected {updates})")
        if any(launches.values()) or any(later.values()):
            raise AssertionError(f"the off-policy path launched a returns kernel: {launches}, "
                                 f"then {later}")
        print(f"hasac path: buffer {rows} rows after the warmup, {(updates - 1) // interval} "
              f"blocks and one more env step; no kernel of the port launched ({launches}, "
              f"then {later})", flush=True)
        return later

    return launches, profile


def small_off_policy_runner(algo: str, device, noise):
    """HalfCheetah-6x1 at small widths: 16 envs, episodes of 5 steps, warmup
    32 rows, 4-step blocks, batch 64."""
    return make_off_policy_runner(algo, device, noise=noise, n_envs=16, hidden=[16, 16],
                                  episode_limit=5, warmup_steps=32, train_interval=4,
                                  batch_size=64, buffer_size=1000,
                                  n_step=3 if algo == "hasac" else None)


def check_off_policy_against_cpu(algo: str, devices=("cpu", "cuda"),
                                 make=small_off_policy_runner, label: str = None) -> None:
    """One small warmup + collect + train of ``algo`` (``make(algo, device,
    noise)``) on the card and on the CPU from the same parameters and the
    same noise (drawn on the CPU). Discrete actions and availability rows
    must be equal, floats close."""
    from harl_tpu_torch.utils.noise import GeneratorNoise

    runs = []
    for dev in devices:
        noise = GeneratorNoise(torch.Generator().manual_seed(5), dev,
                               torch.Generator().manual_seed(5))
        runner = make(algo, dev, noise)
        state = runner.init_state(0)
        if runs:   # the card's runner starts from the CPU runner's parameters
            cpu_state = runs[0][0]
            for a, b in zip(state.actors, cpu_state.actors):
                a.net.load_state_dict(b.net.state_dict())
                a.target.load_state_dict(b.target.state_dict())
            state.critic.nets.load_state_dict(cpu_state.critic.nets.state_dict())
            state.critic.targets.load_state_dict(cpu_state.critic.targets.state_dict())
        runs.append((state, runner))
    outs = []
    for state, runner in runs:
        state = runner.warmup_block(state)
        state, cm = runner.collect_block(state)
        state, tm = runner.train_block(state)
        outs.append((state, cm, tm))
    torch.cuda.synchronize()
    (s_cpu, c_cpu, t_cpu), (s_gpu, c_gpu, t_gpu) = outs
    close = lambda a, b: torch.testing.assert_close(
        torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu(), rtol=E2E_RTOL, atol=E2E_ATOL)
    rows = s_cpu.buffer.cur_size
    if s_gpu.buffer.cur_size != rows or rows != 32 + 4 * 16:
        raise AssertionError(f"{algo}: buffer rows {s_gpu.buffer.cur_size} on the card, "
                             f"{rows} on the CPU")
    for name in ("share_obs", "next_share_obs", "rewards", "dones", "terms"):
        close(getattr(s_gpu.buffer, name)[:rows], getattr(s_cpu.buffer, name)[:rows])
    exact = (("actions", "available_actions", "next_available_actions")
             if runs[0][1].discrete else ())
    for name in ("obs", "next_obs", "actions", "valid_transitions") + exact:
        for a, b in zip(getattr(s_gpu.buffer, name), getattr(s_cpu.buffer, name)):
            if name in exact and not torch.equal(a[:rows].cpu(), b[:rows]):
                raise AssertionError(f"{algo}: buffer {name} differ on the card")
            close(a[:rows], b[:rows])
    for k in ("episode_return_sum", "episode_count", "mean_step_reward"):
        close(c_gpu[k], c_cpu[k])
    close(t_gpu["critic_loss"], t_cpu["critic_loss"])
    pairs = [(a.net, b.net) for a, b in zip(s_gpu.actors, s_cpu.actors)]
    pairs += [(a.target, b.target) for a, b in zip(s_gpu.actors, s_cpu.actors)]
    pairs += [(s_gpu.critic.nets, s_cpu.critic.nets), (s_gpu.critic.targets,
                                                        s_cpu.critic.targets)]
    for a, b in pairs:
        for va, vb in zip(a.state_dict().values(), b.state_dict().values()):
            close(va, vb)
    log(f"small {label or algo} block: card == CPU (buffer rows{', discrete actions and '
        'availability equal' if exact else ''}, losses, actors, critics and targets at rtol "
        f"{E2E_RTOL}, atol {E2E_ATOL}); {float(c_cpu['episode_count']):.0f} episodes ended")


# ------------------------------------------------------- the CLI (phases 12-14)
CLI_HATRPO = "tuned_configs/smaclite/5m_vs_6m/hatrpo/config.json"
CLI_MAPPO = "tuned_configs/mamujoco_jax/HalfCheetah-v2-2x3/mappo/config.json"
CLI_HAA2C = "tuned_configs/mamujoco_jax/HalfCheetah-v2-2x3/haa2c/config.json"
CLI_HASAC = "tuned_configs/mamujoco_jax/HalfCheetah-v2-6x1/hasac/config.json"


class Spy:
    """Wraps a method of a class for the duration of a ``with``: records the
    wall time of each call (ending in ``torch.cuda.synchronize()``), the
    object it was called on, its arguments and ``keep(result)``."""

    def __init__(self, cls, name: str, sync: bool = True, keep=lambda out: out):
        self.cls, self.name, self.sync, self.keep = cls, name, sync, keep
        self.calls = []   # (seconds, self, args, keep(result))

    def __enter__(self):
        orig = self.orig = getattr(self.cls, self.name)

        @functools.wraps(orig)
        def wrapped(obj, *args, **kwargs):
            t0 = time.perf_counter()
            out = orig(obj, *args, **kwargs)
            if self.sync:
                torch.cuda.synchronize()
            self.calls.append((time.perf_counter() - t0, obj, args, self.keep(out)))
            return out

        setattr(self.cls, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self.orig)


def cli_args(config: str, shrink: dict) -> tuple:
    """(the train section of ``config`` with ``shrink`` applied, the
    ``--key value`` overrides of ``shrink``; with a device other than CUDA
    in ``shrink["platform"]``, a rehearsal on it)."""
    with open(config) as f:
        train_args = json.load(f)["algo_args"]["train"]
    train_args.update({k: v for k, v in shrink.items() if k in train_args})
    argv = [x for k, v in shrink.items() for x in (f"--{k}", json.dumps(v) if
                                                  isinstance(v, list) else str(v))]
    return train_args, argv


def zero_launches() -> None:
    from harl_tpu_torch.ops import gae_kernels as K

    K.gae.launches = 0
    K.discounted_returns.launches = 0


def read_launches() -> dict:
    from harl_tpu_torch.ops import gae_kernels as K

    return {"gae": K.gae.launches, "discounted_returns": K.discounted_returns.launches}


def read_run(run_dir: str, n_agents: int, off_policy: bool = False) -> list:
    """The log records of a run directory, checked: config.json, finite
    losses, per-agent stats, a checkpoint."""
    from pathlib import Path

    run = Path(run_dir)
    if not (run / "config.json").exists():
        raise AssertionError(f"{run}: no config.json")
    with open(run / "logs" / "progress.txt") as f:
        recs = [json.loads(line) for line in f]
    train_recs = [r for r in recs if ("critic_loss" if off_policy else "value_loss") in r]
    if not train_recs:
        raise AssertionError(f"{run}: no training record in progress.txt")
    for r in train_recs:
        loss = r["critic_loss" if off_policy else "value_loss"]
        if not math.isfinite(loss):
            raise AssertionError(f"{run}: loss {loss} at step {r['steps']}")
        if not off_policy and (len(r["agent_stats"]) != n_agents or not all(
                math.isfinite(v) for a in r["agent_stats"] for v in a.values())):
            raise AssertionError(f"{run}: agent stats {r['agent_stats']}")
    if not any(d.startswith("ckpt_") for d in os.listdir(run / "models")):
        raise AssertionError(f"{run}: no checkpoint")
    return recs


def hatrpo_phase_times(update_spy, timer) -> str:
    """Per-agent HATRPO update seconds, FVPs and line-search tries."""
    per_agent = [(t, actor.last_fvps, len(actor.last_tries), actor.last_fraction)
                 for t, actor, _, _ in update_spy.calls]
    phases = ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in timer.timings().items())
    return (f"{len(per_agent)} agent updates, {statistics.mean(p[0] for p in per_agent):.4f} s "
            f"each on average ({phases} an agent); FVPs {[p[1] for p in per_agent]}, "
            f"line-search tries {[p[2] for p in per_agent]}, accepted fractions "
            f"{[p[3] for p in per_agent]}")


def drive_cli_hatrpo(card: str, log_dir: str, floor: dict, shrink: dict = None) -> tuple:
    """Phase 12: the tuned HATRPO 5m_vs_6m config through
    ``harl_tpu_torch.train.main`` at its full widths (20 envs x 160 steps,
    FP, GRU, MLP [64, 64, 64]): 2 iterations with evaluation and a
    checkpoint, a resume of one more iteration from that checkpoint, and a
    split iteration in which the GAE kernel is held against its plain
    version on the path's own inputs (T=160, b=100) and timed; HATRPO's
    update is timed by phase in the resumed iteration. Returns (launches,
    the in-situ GAE numbers)."""
    from harl_tpu_torch import train
    from harl_tpu_torch.algos.hatrpo import HATRPOActor
    from harl_tpu_torch.runners.on_policy import OnPolicyRunner
    from harl_tpu_torch.utils import checkpoint
    from harl_tpu_torch.utils.profiling import PhaseTimer

    cfg, extra = cli_args(CLI_HATRPO, shrink or {})
    T, n = cfg["episode_length"], cfg["n_rollout_threads"]
    device = (shrink or {}).get("platform", "cuda")
    zero_launches()
    t0 = time.perf_counter()
    with Spy(OnPolicyRunner, "train_iteration") as its:
        run_dir = train.main(["--load_config", CLI_HATRPO, "--num_env_steps", str(2 * T * n),
                              "--eval_episodes", "10", *extra, "--log_dir", log_dir])
    wall = time.perf_counter() - t0
    launches = read_launches()
    if launches["gae"] < 2 or launches["discounted_returns"] != 0:
        raise AssertionError(f"cli hatrpo: launches {launches} (gae once an iteration)")
    recs = read_run(run_dir, 5)
    evals = [r for r in recs if "eval_return" in r]
    if not evals or not math.isfinite(evals[-1]["eval_return"]) or \
            "eval_win_rate" not in evals[-1]:
        raise AssertionError(f"cli hatrpo: eval records {evals}")
    if not os.path.isdir(os.path.join(run_dir, "models", f"ckpt_{2 * T * n}")):
        raise AssertionError(f"cli hatrpo: no ckpt_{2 * T * n}")
    times = [c[0] for c in its.calls]
    print(f"cli hatrpo smaclite: HATRPO 5m_vs_6m FP GRU, tuned config ({n} envs x {T} steps, "
          f"MLP {cfg_model_widths(its)}) through train.main: {len(times)} iterations of "
          f"{', '.join(f'{t:.4f}' for t in times)} s; {n * T / sum(times[1:]):.1f} env-steps/s "
          f"over iteration 2; main {wall:.2f} s with eval (return "
          f"{evals[-1]['eval_return']:.4f}, win rate {evals[-1]['eval_win_rate']:.4f}) and "
          f"checkpoint; gae launched {launches['gae']} times on {card}", flush=True)

    # a second run resumes from the first's checkpoint: the restored
    # parameters equal the saved ones bitwise, and it trains one iteration
    def net_copies(state):
        return [{k: v.clone() for k, v in st.net.state_dict().items()}
                for st in state.actors + [state.critic]]

    # its iteration times HATRPO's update by phase (a sync at each end)
    timer = PhaseTimer(sync=torch.cuda.synchronize)
    orig_update = HATRPOActor.update

    def timed_update(actor, *args, **kwargs):
        actor.timer = timer
        try:
            return orig_update(actor, *args, **kwargs)
        finally:
            actor.timer = None

    zero_launches()
    HATRPOActor.update = timed_update
    try:
        with Spy(OnPolicyRunner, "restore", sync=False, keep=net_copies) as restores, \
                Spy(OnPolicyRunner, "train_iteration") as its2, \
                Spy(HATRPOActor, "update") as updates:
            run2 = train.main(["--load_config", CLI_HATRPO, "--num_env_steps", str(T * n),
                               "--eval_episodes", "10", *extra, "--model_dir", run_dir,
                               "--log_dir", log_dir + "_resumed"])
    finally:
        HATRPOActor.update = orig_update
    resumed_launches = read_launches()
    (_, runner, _, restored), = restores.calls
    saved = checkpoint.restore_state(checkpoint.latest_checkpoint(run_dir))
    saved_nets = [s["net"] for s in saved["state"]["actors"] + [saved["state"]["critic"]]]
    fresh_runner = OnPolicyRunner(runner.args, runner.algo_args, runner.env_args, device=device)
    fresh = net_copies(fresh_runner.restore(fresh_runner.init_state(7), run_dir))
    for nets in (restored, fresh):   # the resumed run's, and a fresh state's
        for sd, sd_saved in zip(nets, saved_nets):
            for k, v in sd.items():
                if not torch.equal(v, sd_saved[k].to(v.device)):
                    raise AssertionError(f"restore: {k} differs from the checkpoint")
    if len(its2.calls) != 1 or resumed_launches["gae"] != 1:
        raise AssertionError(f"resumed run: {len(its2.calls)} iterations, {resumed_launches}")
    read_run(run2, 5)
    trained = checkpoint.restore_state(checkpoint.latest_checkpoint(run2))
    if all(torch.equal(v, trained["state"]["actors"][0]["net"][k])
           for k, v in saved["state"]["actors"][0]["net"].items()):
        raise AssertionError("resumed run: the actor did not move")
    print(f"cli hatrpo resume: restored parameters equal the checkpoint bitwise; one more "
          f"iteration {its2.calls[0][0]:.4f} s (HATRPO's phases timed with a sync at each end), "
          f"gae launched {resumed_launches['gae']} time; HATRPO: "
          f"{hatrpo_phase_times(updates, timer)} on {card}", flush=True)
    launches = {k: launches[k] + resumed_launches[k] for k in launches}

    # one more rollout of the resumed runner, then the GAE kernel on its own
    # inputs against the plain version
    _, runner, (state,), _ = its2.calls[-1]
    return launches, gae_in_situ("cli hatrpo", runner, state, (T, n, 5, 1), floor, card)


def gae_in_situ(label: str, runner, state, shape: tuple, floor: dict, card: str) -> dict:
    """One more rollout (a host runner's: a collection) of an on-policy
    ``runner`` from ``state``, then the GAE kernel on that rollout's own
    returns inputs (of ``shape``, T first) held against its plain version
    and timed warm; its launches here are not counted. Returns the kernel's
    numbers on those inputs."""
    from harl_tpu_torch.ops import gae_kernels as K

    first_masks0 = state.carry.masks[:, 0]
    t0 = time.perf_counter()
    data = runner.collect_host(state) if runner.host_mode else runner.rollout(state)
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t0
    c = state.carry
    rewards, values, masks, bad = (None if x is None else x.contiguous()
                                   for x in runner.returns_inputs(state, data, first_masks0,
                                                                  c.share_obs, c.masks,
                                                                  c.critic_rnn))
    if tuple(rewards.shape) != tuple(shape):
        raise AssertionError(f"{label}: GAE inputs of shape {tuple(rewards.shape)}, expected "
                             f"{tuple(shape)}")
    T = shape[0]
    b = rewards.numel() // T
    args = (rewards, values, masks, bad, runner.gamma, runner.gae_lambda)
    before = K.gae.launches
    out = K.gae(*args)
    torch.cuda.synchronize()
    ref = K.gae_reference(*args)
    torch.testing.assert_close(out, ref, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    err = (out - ref).abs().max().item()
    ms = time_warm(lambda: K.gae(*args), reps=200)[0]
    K.gae.launches = before
    bms, by = bound_ms("gae", T, b)
    print(f"{label} rollout {rollout_s:.4f} s; gae on the path's own inputs (T={T}, b={b}): "
          f"kernel == plain (max |err| {err:.3g}, rtol {KERNEL_RTOL}, atol {KERNEL_ATOL}); "
          f"{ms * 1e3:.3f} us warm on the device, bound {bms * 1e3:.3f} us ({by}), share "
          f"{bms / ms:.3f}; empty launch {floor['ms'] * 1e3:.3f} us, on {card}", flush=True)
    return dict(T=T, b=b, ms=ms, max_abs_err=err, bound_ms=bms, bound_by=by)


def cfg_model_widths(spy) -> list:
    return list(spy.calls[0][1].hidden_sizes)


def drive_cli_paths(card: str, log_dir: str, shrink: dict = None) -> dict:
    """Phase 13: the other CLI paths from their tuned configs, without
    evaluation: MAPPO with share_param on HalfCheetah 2x3 (2 iterations of
    20 envs x 200 steps, MLP [128, 128, 128], 15 epochs), HAA2C with linear
    lr decay (2 iterations, then one with ``use_gae False`` through the
    returns kernel), and HASAC on HalfCheetah 6x1 (its warmup and 2
    blocks). Returns the launches by path."""
    from harl_tpu_torch import train

    by_path = {}
    for label, config, iterations, argv, n_agents, off, expect in (
            ("cli_mappo_halfcheetah", CLI_MAPPO, 2, [], 2, False,
             {"gae": 2, "discounted_returns": 0}),
            ("cli_haa2c_halfcheetah", CLI_HAA2C, 2, [], 2, False,
             {"gae": 2, "discounted_returns": 0}),
            ("cli_haa2c_halfcheetah_returns", CLI_HAA2C, 1, ["--use_gae", "False"], 2, False,
             {"gae": 0, "discounted_returns": 1}),
            ("cli_hasac_halfcheetah", CLI_HASAC, 2, [], 6, True,
             {"gae": 0, "discounted_returns": 0})):
        cfg, extra = cli_args(config, shrink or {})
        # iterations of T steps, or blocks of train_interval steps, of n envs
        steps = iterations * cfg.get("episode_length", cfg.get("train_interval")) * \
            cfg["n_rollout_threads"]
        argv = ["--num_env_steps", str(steps), *argv]
        zero_launches()
        t0 = time.perf_counter()
        run = train.main(["--load_config", config, "--use_eval", "False", *argv, *extra,
                          "--log_dir", os.path.join(log_dir, label)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        if launches != expect:
            raise AssertionError(f"{label}: launches {launches}, expected {expect}")
        recs = read_run(run, n_agents, off)
        print(f"{label}: {config} {' '.join(argv + extra)} through train.main in {wall:.2f} s (last "
              f"record: steps {recs[-1]['steps']}, fps {recs[-1]['fps']:.1f}); launches "
              f"{launches} on {card}", flush=True)
        by_path[label] = launches
    haa2c = by_path.pop("cli_haa2c_halfcheetah_returns")
    by_path["cli_haa2c_halfcheetah"] = {k: v + haa2c[k]
                                        for k, v in by_path["cli_haa2c_halfcheetah"].items()}
    return by_path


def make_family_runner(algo: str, env: str, device, noise, model: dict = None,
                       **algo_updates):
    """A small on-policy runner: 3m FP GRU or HalfCheetah 2x3; ``model``
    updates the model section."""
    from harl_tpu_torch.runners.on_policy import OnPolicyRunner
    from harl_tpu_torch.utils.config_tools import get_defaults_yaml_args

    algo_args, env_args = get_defaults_yaml_args(algo, env)
    algo_args["train"].update(n_rollout_threads=8, episode_length=10, num_env_steps=10 ** 9)
    algo_args["model"].update(hidden_sizes=[16, 16], **(model or {}))
    algo_args["algo"].update(**algo_updates)
    if env == "smaclite":
        algo_args["model"].update(use_recurrent_policy=True, data_chunk_length=5)
        env_args.update(map_name="3m", state_type="FP", episode_limit=8)
    else:
        env_args.update(scenario="HalfCheetah-v2", agent_conf="2x3", episode_limit=5)
    return OnPolicyRunner({"algo": algo, "env": env}, algo_args, env_args, device=device,
                          noise=noise)


def check_family_against_cpu(label: str, algo: str, env: str, devices=("cpu", "cuda"),
                             model: dict = None, **algo_updates) -> None:
    """Phase 14: one small iteration on the card and on the CPU from the
    same parameters and noise; HATRPO's accepted fractions are printed for
    both devices."""
    from harl_tpu_torch.utils.noise import GeneratorNoise

    runs = []
    for dev in devices:
        noise = GeneratorNoise(torch.Generator().manual_seed(6), dev)
        runner = make_family_runner(algo, env, dev, noise, model, **algo_updates)
        state = runner.init_state(0)
        if runs:   # the card's runner starts from the CPU runner's parameters
            cpu_state = runs[0][0]
            for a, b in zip(state.actors + [state.critic], cpu_state.actors + [cpu_state.critic]):
                a.net.load_state_dict(b.net.state_dict())
        runs.append((state, runner))
    out = [runner.train_iteration(state) for state, runner in runs]
    torch.cuda.synchronize()
    (s_cpu, m_cpu), (s_gpu, m_gpu) = out
    fractions = (m_cpu.get("ls_fraction"), m_gpu.get("ls_fraction"))
    if algo == "hatrpo":
        print(f"{label}: accepted line-search fractions, CPU {fractions[0]}, card "
              f"{fractions[1]}", flush=True)
        if fractions[0] != fractions[1]:
            raise AssertionError(f"{label}: the line search accepted other fractions on the "
                                 f"card ({fractions[1]}) than on the CPU ({fractions[0]})")
    close = lambda a, b: torch.testing.assert_close(
        torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu(), rtol=E2E_RTOL, atol=E2E_ATOL)
    for k in ("value_loss", "critic_grad_norm", "mean_step_reward", "episode_return_sum"):
        close(m_gpu[k], m_cpu[k])
    close(m_gpu["actor_stats"], m_cpu["actor_stats"])
    for a, b in zip(s_gpu.actors + [s_gpu.critic], s_cpu.actors + [s_cpu.critic]):
        for va, vb in zip(a.net.state_dict().values(), b.net.state_dict().values()):
            close(va, vb)
    close(s_gpu.carry.obs, s_cpu.carry.obs)
    log(f"small {label} iteration: card == CPU (rtol {E2E_RTOL}, atol {E2E_ATOL})")


# ------------------------------------------- MPE, Walker2d, Hopper (phase 15)
MPE_HAPPO = "tuned_configs/pettingzoo_mpe/simple_spread_v2-continuous/happo/config.json"
WALKER_HAPPO = "tuned_configs/mamujoco_jax/Walker2d-v2-6x1/happo/config.json"
HOPPER_HATD3 = "tuned_configs/mamujoco_jax/Hopper-v2-3x1/hatd3/config.json"
MPE_HASAC = "tuned_configs/pettingzoo_mpe/simple_speaker_listener_v3-discrete/hasac/config.json"
MPE_HAD3QN = "tuned_configs/pettingzoo_mpe/simple_spread_v2-discrete/had3qn/config.json"
# (label, config, iterations or blocks, agents, off-policy, evaluate)
SLICE6_PATHS = (("mpe_happo", MPE_HAPPO, 2, 3, False, True),
                ("walker_happo", WALKER_HAPPO, 2, 6, False, False),
                ("hopper_hatd3", HOPPER_HATD3, 2, 3, True, False),
                ("mpe_hasac_discrete", MPE_HASAC, 2, 2, True, False),
                ("mpe_had3qn", MPE_HAD3QN, 2, 3, True, False))


class Watch(Spy):
    """A ``Spy`` that reads something of every call on the device and checks
    it once the run is over: ``read(obj, args, out)`` returns a tensor of
    counts, summed over the calls; ``report(totals)`` returns a line or
    raises. No call waits on the device."""

    def __init__(self, cls, name: str, read, report):
        super().__init__(cls, name, sync=False)
        self.read, self.report_fn, self.totals = read, report, None

    def __enter__(self):
        orig = self.orig = getattr(self.cls, self.name)

        @functools.wraps(orig)
        def wrapped(obj, *args, **kwargs):
            out = orig(obj, *args, **kwargs)
            counts = self.read(obj, args, out).to(torch.int64)
            self.totals = counts if self.totals is None else self.totals + counts
            return out

        setattr(self.cls, self.name, wrapped)
        return self

    def report(self) -> str:
        return self.report_fn(None if self.totals is None else self.totals.tolist())


def unhealthy_watch() -> Watch:
    """Env steps that ended unhealthy in an on-policy rollout: masks 0 where
    the bad mask is 1 (a termination, not a truncation)."""
    from harl_tpu_torch.runners.on_policy import OnPolicyRunner

    def report(totals):
        if not totals or totals[0] < 1:
            raise AssertionError("no episode ended unhealthy")
        return f"{totals[0]} env steps ended unhealthy (masks 0, bad masks 1)"

    return Watch(OnPolicyRunner, "returns_inputs",
                 lambda obj, args, out: ((out[2] == 0) & (out[3] == 1)).sum()[None], report)


def drive_tuned_paths(card: str, log_dir: str, paths, shrink: dict = None,
                      watches: dict = None, last: dict = None) -> dict:
    """Tuned configs as they are (only iterations or blocks cut) through
    ``harl_tpu_torch.train.main``. ``paths`` holds (label, config, iterations
    or blocks, agents, off-policy, evaluate); ``watches`` maps a label to
    functions that make its ``Watch``es. Each path prints env-steps/s over its
    timed iterations or blocks after the first; the GAE kernel must run once
    an on-policy iteration and no kernel on an off-policy path. Returns the
    launches by path; ``last``, where given, gets each on-policy path's
    runner and the state its last iteration returned."""
    from harl_tpu_torch import train
    from harl_tpu_torch.runners.off_policy import OffPolicyRunner
    from harl_tpu_torch.runners.on_policy import OnPolicyRunner

    by_path = {}
    for label, config, count, n_agents, off, evaluate in paths:
        cfg, extra = cli_args(config, shrink or {})
        n = cfg["n_rollout_threads"]
        steps_each = cfg["train_interval"] if off else cfg["episode_length"]
        argv = ["--num_env_steps", str(count * steps_each * n), "--use_eval", str(evaluate)]
        watchers = [make() for make in (watches or {}).get(label, ())]
        zero_launches()
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            for w in watchers:
                stack.enter_context(w)
            if off:
                warm = stack.enter_context(Spy(OffPolicyRunner, "warmup_block"))
                collects = stack.enter_context(Spy(OffPolicyRunner, "collect_block"))
                trains = stack.enter_context(Spy(OffPolicyRunner, "train_block"))
            else:
                its = stack.enter_context(Spy(OnPolicyRunner, "train_iteration"))
            run = train.main(["--load_config", config, *argv, *extra,
                              "--log_dir", os.path.join(log_dir, label)])
        if off:
            times = [c[0] + t[0] for c, t in zip(collects.calls, trains.calls)]
            widths = list(warm.calls[0][1].actors[0].hidden_sizes)
        else:
            times = [c[0] for c in its.calls]
            widths = cfg_model_widths(its)
            if last is not None:
                last[label] = (its.calls[-1][1], its.calls[-1][3][0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        expect = {"gae": 0 if off else count, "discounted_returns": 0}
        if launches != expect or len(times) != count:
            raise AssertionError(f"{label}: launches {launches} (expected {expect}), "
                                 f"{len(times)} timed parts (expected {count})")
        recs = read_run(run, n_agents, off)
        what = ""
        if evaluate:
            evals = [r for r in recs if "eval_return" in r]
            if not evals or not math.isfinite(evals[-1]["eval_return"]):
                raise AssertionError(f"{label}: eval records {evals}")
            what = f", eval return {evals[-1]['eval_return']:.4f}"
        for w in watchers:
            try:
                what += f", {w.report()}"
            except AssertionError as e:
                raise AssertionError(f"{label}: {e}") from None
        if off:
            buf = warm.calls[0][3].buffer
            nbytes = sum(x.numel() * x.element_size() for x in vars(buf).values()
                         if isinstance(x, torch.Tensor))
            nbytes += sum(x.numel() * x.element_size() for v in vars(buf).values()
                          if isinstance(v, list) for x in v)
            what += (f", warmup {warm.calls[0][0]:.4f} s, replay buffer of {buf.buffer_size} "
                     f"rows ({type(buf).__name__}) {nbytes / 2 ** 30:.3f} GiB on the card")
        rate = (len(times) - 1) * steps_each * n / sum(times[1:]) if count > 1 else (
            steps_each * n / times[0])
        over = f"the last {len(times) - 1}" if count > 1 else "its one (warm-up included)"
        print(f"{label}: {config} ({n} envs, {'blocks of ' if off else ''}{steps_each} steps, "
              f"MLP {widths}) through train.main in {wall:.2f} s; {'blocks' if off else 'iterations'}"
              f" of {', '.join(f'{t:.4f}' for t in times)} s, {rate:.1f} env-steps/s over "
              f"{over}{what}; launches {launches} on {card}", flush=True)
        by_path[label] = launches
    return by_path


def drive_slice6_paths(card: str, log_dir: str, shrink: dict = None) -> dict:
    """Phase 15 (a)-(e): the tuned configs as they are (only iterations or
    blocks cut) through ``harl_tpu_torch.train.main``: (a) HAPPO on MPE
    simple_spread (continuous), 2 iterations of 20 envs x 200 steps with
    evaluation at the 25-step horizon; (b) HAPPO on Walker2d 6x1, 2 iterations
    of 20 x 200, where an episode must end unhealthy (a termination, masks 0
    with bad masks 1); (c) HATD3 on Hopper 3x1, (d) discrete HASAC on
    speaker-listener (n_step 20, auto-α, buffer 1,000,000 rows) and (e)
    HAD3QN on discrete simple_spread (125 joint actions), each its warmup
    and 2 blocks. Returns the launches by path: GAE once an iteration on (a)
    and (b), no kernel on (c)-(e)."""
    return drive_tuned_paths(card, log_dir, SLICE6_PATHS, shrink,
                             {"walker_happo": (unhealthy_watch,)})


def small_mpe_runner(algo: str, device, noise):
    """Discrete MPE at small widths, HASAC on speaker-listener (Discrete(3)
    and Discrete(5)) or HAD3QN on simple_spread: the block sizes of
    ``small_off_policy_runner``, episodes of 5 steps."""
    from harl_tpu_torch.runners.off_policy import OffPolicyRunner
    from harl_tpu_torch.utils.config_tools import get_defaults_yaml_args

    algo_args, _ = get_defaults_yaml_args(algo, "pettingzoo_mpe")
    algo_args["train"].update(n_rollout_threads=16, num_env_steps=10 ** 9, warmup_steps=32,
                              train_interval=4, update_per_train=1)
    algo_args["algo"].update(batch_size=64, buffer_size=1000)
    algo_args["model"].update(hidden_sizes=[16, 16])
    if algo == "hasac":
        algo_args["algo"].update(n_step=3, auto_alpha=True)
    scenario = "simple_speaker_listener_v3" if algo == "hasac" else "simple_spread_v2"
    return OffPolicyRunner({"algo": algo, "env": "pettingzoo_mpe"}, algo_args,
                           {"scenario": scenario, "continuous_actions": False, "max_cycles": 5},
                           device=device, noise=noise)


def tip_walker(env):
    """Walker2d: half the envs pitched forward and spun, so that they fall."""
    tip = torch.zeros_like(env.q)
    tip[::2, 2] = 0.97
    return env._replace(q=env.q + tip, qd=env.qd + 4.0 * (tip != 0))


def sink_ant(env):
    """Ant: half the torsos just above the 0.2 height bound and falling."""
    q, qd = env.q.clone(), env.qd.clone()
    q[::2, 2], qd[::2, 2] = 0.25, -8.0
    return env._replace(q=q, qd=qd)


def check_walker_against_cpu(devices=("cpu", "cuda"), label: str = "walker2d",
                             env_updates=None, perturb=tip_walker, env: str = "mamujoco_jax",
                             unhealthy: bool = True) -> None:
    """Phase 15 (f), Walker2d (and phase 16 (e), the Ant 4x2; phase 17 (e),
    the Humanoid and TwoCatchUnderarm): one small HAPPO iteration (16 envs x
    10 steps) of ``env`` on the card and on the CPU from the same parameters
    and noise, half the envs ``perturb``ed (with ``unhealthy``, so that they
    end unhealthy inside the rollout): masks and bad masks equal, floats
    close."""
    from harl_tpu_torch.runners.on_policy import OnPolicyRunner
    from harl_tpu_torch.utils.config_tools import get_defaults_yaml_args
    from harl_tpu_torch.utils.noise import GeneratorNoise

    runs = []
    for dev in devices:
        algo_args, env_args = get_defaults_yaml_args("happo", env)
        algo_args["train"].update(n_rollout_threads=16, episode_length=10, num_env_steps=10 ** 9)
        algo_args["model"].update(hidden_sizes=[16, 16])
        env_args.update(env_updates or dict(scenario="Walker2d-v2", agent_conf="2x3"))
        if env == "mamujoco_jax":
            env_args.update(episode_limit=1000)
        runner = OnPolicyRunner({"algo": "happo", "env": env}, algo_args, env_args,
                                device=dev, noise=GeneratorNoise(torch.Generator().manual_seed(6),
                                                                 dev))
        state = runner.init_state(0)
        state.carry = state.carry._replace(env_state=perturb(state.carry.env_state))
        if runs:   # the card's runner starts from the CPU runner's parameters
            for a, b in zip(state.actors + [state.critic], runs[0][0].actors + [runs[0][0].critic]):
                a.net.load_state_dict(b.net.state_dict())
        runs.append((state, runner))
    outs = []
    for state, runner in runs:
        first_masks0 = state.carry.masks[:, 0]
        data = runner.rollout(state)
        c = state.carry
        outs.append((data, runner.update_phase(state, data, first_masks0, c.share_obs, c.masks,
                                               c.critic_rnn)))
    torch.cuda.synchronize()
    (d_cpu, m_cpu), (d_gpu, m_gpu) = outs
    for k in ("next_masks", "next_bad_masks", "masks"):
        if not torch.equal(d_gpu[k].cpu(), d_cpu[k]):
            raise AssertionError(f"{label}: {k} differ on the card")
    ended = int(((d_cpu["next_masks"] == 0) & (d_cpu["next_bad_masks"] == 1)).sum())
    if unhealthy and ended < 1:
        raise AssertionError(f"{label}: no env ended unhealthy in the small iteration")
    close = lambda a, b: torch.testing.assert_close(
        torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu(), rtol=E2E_RTOL, atol=E2E_ATOL)
    for a, b in zip(d_gpu["actions"], d_cpu["actions"]):
        close(a, b)
    for k in ("value_loss", "critic_grad_norm", "mean_step_reward", "episode_return_sum"):
        close(m_gpu[k], m_cpu[k])
    close(m_gpu["actor_stats"], m_cpu["actor_stats"])
    for a, b in zip(runs[1][0].actors + [runs[1][0].critic],
                    runs[0][0].actors + [runs[0][0].critic]):
        for va, vb in zip(a.net.state_dict().values(), b.net.state_dict().values()):
            close(va, vb)
    log(f"small {label} iteration: card == CPU (masks and bad masks equal, {ended} env steps "
        f"ended by a termination; floats at rtol {E2E_RTOL}, atol {E2E_ATOL})")


def check_slice6_against_cpu(devices=("cpu", "cuda")) -> None:
    """Phase 15 (f): discrete HASAC and HAD3QN blocks and a Walker2d
    iteration through termination, on the card against the CPU."""
    for algo in ("hasac", "had3qn"):
        check_off_policy_against_cpu(algo, devices, make=small_mpe_runner,
                                     label=f"{algo} discrete mpe")
    check_walker_against_cpu(devices)


# ---------------------------------- SMACv2, FP HASAC, the 3D Ant (phase 16)
SMACV2_HAPPO = "tuned_configs/smacv2/protoss_5_vs_5/happo/config.json"
SMACV2_HATRPO = "tuned_configs/smacv2/terran_5_vs_5/hatrpo/config.json"
FP_HASAC = "tuned_configs/smaclite/5m_vs_6m/hasac/config.json"
ANT_HAPPO = "tuned_configs/mamujoco_jax/Ant-v2-4x2/happo/config.json"
# (label, config, iterations or blocks, agents, off-policy, evaluate)
SLICE7_PATHS = (("smacv2_happo", SMACV2_HAPPO, 2, 5, False, False),
                ("smacv2_hatrpo", SMACV2_HATRPO, 1, 5, False, False),
                ("smaclite_fp_hasac", FP_HASAC, 2, 5, True, False),
                ("ant_happo", ANT_HAPPO, 2, 4, False, False))


def smacv2_draws_watch() -> Watch:
    """Every SMACv2 reset: envs that spawned surrounded, envs that spawned
    reflected, and envs whose ally team differs from the first env's."""
    from harl_tpu_torch.envs.smaclite.smaclite import SMACLite

    def read(env, args, out):
        surround = args[0][2][:, 0] < env.surround_p
        differ = (out[0] != out[0][:1]).any(dim=1)
        return torch.stack([surround.sum(), (~surround).sum(), differ.sum()])

    def report(totals):
        if not totals or min(totals) < 1:
            raise AssertionError(f"resets (surrounded, reflected, teams unlike env 0's) "
                                 f"{totals}: a spawn branch or a second team is missing")
        return (f"resets drew {totals[0]} surrounded and {totals[1]} reflected spawns, "
                f"{totals[2]} env teams unlike env 0's")

    return Watch(SMACLite, "_randomized", read, report)


def medivac_watch() -> Watch:
    """Env steps with a medivac among the allies, and allies healed (health
    only rises by a medivac's heal)."""
    from harl_tpu_torch.envs.smaclite.smaclite import MEDIVAC, SMACLite

    def read(env, args, out):
        state, new = args[0], out[0]
        healed = (new.ally_health > state.ally_health) & (state.ally_health > 0)
        return torch.stack([(state.ally_type == MEDIVAC).any(dim=1).sum(), healed.sum()])

    def report(totals):
        if not totals or min(totals) < 1:
            raise AssertionError(f"(env steps with a medivac, allies healed) {totals}: no "
                                 f"medivac drawn or no heal")
        return f"{totals[0]} env steps with a medivac, {totals[1]} heals"

    return Watch(SMACLite, "step", read, report)


def drive_slice7_paths(card: str, log_dir: str, shrink: dict = None) -> tuple:
    """Phase 16 (a)-(d): the tuned configs as they are (only iterations or
    blocks cut, no eval) through ``harl_tpu_torch.train.main``: (a) HAPPO on
    SMACv2 protoss_5_vs_5 (20 envs x 160 steps, GRU, MLP [64], EP), 2
    iterations, both spawn branches and differing teams required; (b)
    HATRPO on SMACv2 terran_5_vs_5, 1 iteration, a medivac drawn and healing
    required; (c) FP HASAC on SMACLite 5m_vs_6m (n_step 20, auto-α,
    [256, 256], buffer 1,000,000 rows), its 10,000-step warmup and 2 blocks;
    (d) HAPPO on the Ant 4x2 (20 x 200, [128, 128, 128]), 2 iterations.
    Returns (the launches by path: GAE once an iteration on (a), (b) and (d),
    none on (c); a function that counts the device ops of one Ant env step,
    for ``main`` to call after every timed run)."""
    by_path = drive_tuned_paths(card, log_dir, SLICE7_PATHS, shrink,
                                {"smacv2_happo": (smacv2_draws_watch,),
                                 "smacv2_hatrpo": (medivac_watch,)})

    def profile(device="cuda"):
        from harl_tpu_torch.envs import make_env
        from harl_tpu_torch.envs.core import VecEnv
        from harl_tpu_torch.envs.mamujoco_jax.ant import FRAME_SKIP
        from harl_tpu_torch.utils.noise import GeneratorNoise

        env = make_env("mamujoco_jax", {"scenario": "Ant-v2", "agent_conf": "4x2"}, device)
        vec = VecEnv(env, 20)
        noise = GeneratorNoise(torch.Generator(device=device).manual_seed(0), device)
        state, _ = vec.reset(noise)
        actions = torch.zeros((20, 4, 2), device=device)
        step_ops, step_ms = count_device_ops(lambda: env.step(state, actions))
        sub_ops, sub_ms = count_device_ops(
            lambda: env.dyn.substep(state.q, state.qd, actions.reshape(20, 8)))
        vec_ops, vec_ms = count_device_ops(lambda: vec.step(state, actions, noise))
        print(f"ant device ops (20 envs): one env step ({FRAME_SKIP} substeps) {step_ops} "
              f"ops, {step_ms:.3f} ms device time; one substep {sub_ops} ops, {sub_ms:.3f} ms; "
              f"with the auto-reset {vec_ops} ops, {vec_ms:.3f} ms, on {card}", flush=True)

    return by_path, profile


def small_fp_hasac_runner(algo: str, device, noise):
    """FP HASAC on SMACLite 3m at small widths: the block sizes of
    ``small_off_policy_runner``, episodes of 5 steps, auto-α."""
    from harl_tpu_torch.runners.off_policy import OffPolicyRunner
    from harl_tpu_torch.utils.config_tools import get_defaults_yaml_args

    algo_args, _ = get_defaults_yaml_args(algo, "smaclite")
    algo_args["train"].update(n_rollout_threads=16, num_env_steps=10 ** 9, warmup_steps=32,
                              train_interval=4, update_per_train=1)
    algo_args["algo"].update(batch_size=64, buffer_size=1000, n_step=3, auto_alpha=True)
    algo_args["model"].update(hidden_sizes=[16, 16])
    return OffPolicyRunner({"algo": algo, "env": "smaclite"}, algo_args,
                           {"map_name": "3m", "state_type": "FP", "episode_limit": 5},
                           device=device, noise=noise)


def check_slice7_against_cpu(devices=("cpu", "cuda")) -> None:
    """Phase 16 (e): a SMACv2 reset and 20 steps of a small HAPPO iteration
    (protoss_5_vs_5), an FP HASAC block on 3m and an Ant 4x2 iteration
    through unhealthy terminations, on the card against the CPU."""
    check_smaclite_against_cpu(devices, map_name="protoss_5_vs_5", T=20)
    check_off_policy_against_cpu("hasac", devices, make=small_fp_hasac_runner,
                                 label="FP hasac smaclite 3m")
    check_walker_against_cpu(devices, "ant 4x2", {"scenario": "Ant-v2", "agent_conf": "4x2"},
                             sink_ant)


# ------------------------- dexhands, Humanoid and HumanoidStandup (phase 17)
HUMANOID_HAPPO = "tuned_configs/mamujoco_jax/Humanoid-v2-17x1/happo/config.json"
STANDUP_HASAC = "tuned_configs/mamujoco_jax/HumanoidStandup-v2-17x1/hasac/config.json"
HANDOVER_HAPPO = "tuned_configs/dexhands_jax/ShadowHandOver/happo/config.json"
LIFT_HASAC = "tuned_configs/dexhands_jax/ShadowHandLiftUnderarm/hasac/config.json"
# (label, config, iterations or blocks, agents, off-policy, evaluate)
SLICE8_PATHS = (("humanoid_happo", HUMANOID_HAPPO, 2, 17, False, False),
                ("humanoidstandup_hasac", STANDUP_HASAC, 2, 17, True, False),
                ("shadowhandover_happo", HANDOVER_HAPPO, 2, 2, False, False),
                ("liftunderarm_hasac", LIFT_HASAC, 2, 2, True, False))


def tip_force_watch() -> Watch:
    """Substeps of a table task in which the fingertips push an object: the
    envs whose summed fingertip force on their objects is not zero,
    recomputed from each substep's own inputs."""
    from harl_tpu_torch.envs.dexhands_jax.handover import DT
    from harl_tpu_torch.envs.dexhands_jax.manip import ShadowHandManip, tip_sphere_contact

    def read(env, args, out):
        theta, pos, vel, new_theta = args[0], args[4], args[5], out[0]
        tips, tips_v = env._tips(new_theta, (new_theta - theta) / DT)
        X = tips.shape[0]
        f = tip_sphere_contact(tips.reshape(X, 1, -1, 3), tips_v.reshape(X, 1, -1, 3), pos, vel,
                               env.radii[:, None])
        return (torch.linalg.vector_norm(f, dim=-1).sum(dim=1) > 0).sum()[None]

    def report(totals):
        if not totals or totals[0] < 1:
            raise AssertionError("no fingertip ever pushed the object")
        return f"{totals[0]} env substeps with a nonzero fingertip force on the object"

    return Watch(ShadowHandManip, "_substep", read, report)


def drive_slice8_paths(card: str, log_dir: str, floor: dict, shrink: dict = None) -> tuple:
    """Phase 17 (a)-(d): the tuned configs as they are (only iterations or
    blocks cut, no eval) through ``harl_tpu_torch.train.main``: (a) HAPPO on
    Humanoid 17x1 (20 envs x 200 steps, [128, 128, 128], fixed obs scaling),
    2 iterations, an unhealthy termination required; (b) HASAC on
    HumanoidStandup 17x1 ([256, 256], ``n_step`` 10, buffer 1,000,000 rows),
    its 10,000-step warmup and 2 blocks; (c) HAPPO on ShadowHandOver (256
    envs x 75 steps, [256, 256, 256], gamma 0.95), 2 iterations, then one
    more rollout on whose GAE inputs (T=75, b=256) the kernel is held
    against its plain version and timed; (d) HASAC on ShadowHandLiftUnderarm
    (``n_step`` 20, auto-alpha, [256, 256], buffer 1,000,000 rows), its
    warmup and 2 blocks, a fingertip pushing the pot required. Returns (the
    launches by path: GAE once an iteration on (a) and (c), none on (b) and
    (d); the GAE kernel's numbers on (c)'s inputs; a function that counts the
    device ops of one Humanoid and one ShadowHandOver env step, for ``main``
    to call after every timed run)."""
    last = {}
    by_path = drive_tuned_paths(card, log_dir, SLICE8_PATHS, shrink,
                                {"humanoid_happo": (unhealthy_watch,),
                                 "liftunderarm_hasac": (tip_force_watch,)}, last)
    runner, state = last["shadowhandover_happo"]
    T, n = runner.episode_length, runner.n_rollout_threads
    in_situ = gae_in_situ("shadowhandover happo", runner, state, (T, n, 1), floor, card)

    def profile(device="cuda"):
        from harl_tpu_torch.envs import make_env
        from harl_tpu_torch.envs.core import VecEnv
        from harl_tpu_torch.utils.noise import GeneratorNoise

        for label, env_name, args, X in (
                ("humanoid 17x1", "mamujoco_jax",
                 {"scenario": "Humanoid-v2", "agent_conf": "17x1", "obs_standardize": False}, 20),
                ("shadowhandover", "dexhands_jax", {"task": "ShadowHandOver"}, 256)):
            env = make_env(env_name, args, device)
            vec = VecEnv(env, X)
            noise = GeneratorNoise(torch.Generator(device=device).manual_seed(0), device)
            st, _ = vec.reset(noise)
            width = max(sp.shape[0] for sp in env.action_space)
            actions = torch.zeros((X, env.n_agents, width), device=device)
            step_ops, step_ms = count_device_ops(lambda: env.step(st, actions))
            vec_ops, vec_ms = count_device_ops(lambda: vec.step(st, actions, noise))
            print(f"{label} device ops ({X} envs): one env step {step_ops} ops, {step_ms:.3f} ms "
                  f"device time; with the auto-reset {vec_ops} ops, {vec_ms:.3f} ms, on {card}",
                  flush=True)

    return by_path, in_situ, profile


def lift_humanoid(env):
    """Humanoid: half the torsos lifted past the 2.0 height bound, so that
    they end unhealthy on their first step."""
    q = env.q.clone()
    q[::2, 2] = 2.3
    return env._replace(q=q)


def collide_objects(env):
    """TwoCatchUnderarm: in half the envs the two objects overlap above the
    thrower, closing in on each other."""
    pos, vel = env.obj_pos.clone(), env.obj_vel.clone()
    pos[::2, 1] = pos[::2, 0] + torch.tensor([0.06, 0.0, 0.0], device=pos.device)
    vel[::2, 0, 0], vel[::2, 1, 0] = 0.5, -0.5
    return env._replace(obj_pos=pos, obj_vel=vel)


def small_dexhands_hasac_runner(algo: str, device, noise):
    """HASAC on the hinge task DoorOpenOutward at small widths: the block
    sizes of ``small_off_policy_runner``, episodes of 5 steps."""
    from harl_tpu_torch.runners.off_policy import OffPolicyRunner
    from harl_tpu_torch.utils.config_tools import get_defaults_yaml_args

    algo_args, _ = get_defaults_yaml_args(algo, "dexhands_jax")
    algo_args["train"].update(n_rollout_threads=16, num_env_steps=10 ** 9, warmup_steps=32,
                              train_interval=4, update_per_train=1)
    algo_args["algo"].update(batch_size=64, buffer_size=1000, n_step=3)
    algo_args["model"].update(hidden_sizes=[16, 16])
    return OffPolicyRunner({"algo": algo, "env": "dexhands_jax"}, algo_args,
                           {"task": "ShadowHandDoorOpenOutward", "hands_episode_length": 5},
                           device=device, noise=noise)


def check_env_against_cpu(label: str, env_name: str, env_args: dict, steps: int,
                          devices=("cpu", "cuda"), n_envs: int = 16) -> list:
    """A reset and ``steps`` steps of random actions through the auto-reset
    on the card and on the CPU, from the same draws (made on the CPU): the
    states and the timesteps' floats at the E2E tolerance, their integers and
    flags (dones, bad masks, ``won``, layouts, step counts) equal. Returns
    the CPU's states."""
    from harl_tpu_torch.envs import make_env
    from harl_tpu_torch.envs.core import VecEnv
    from harl_tpu_torch.utils.noise import GeneratorNoise

    runs = []
    for dev in devices:
        env = make_env(env_name, env_args, dev)
        vec = VecEnv(env, n_envs)
        noise = GeneratorNoise(torch.Generator().manual_seed(7), dev)
        gen = torch.Generator().manual_seed(8)
        width = max(sp.shape[0] for sp in env.action_space)
        state, ts = vec.reset(noise)
        trace = [(state, ts)]
        for _ in range(steps):
            a = torch.rand((n_envs, env.n_agents, width), generator=gen) * 2.0 - 1.0
            tr = vec.step(state, a.to(dev), noise)
            state = tr.state
            trace.append((state, tr.final))
        runs.append(trace)
    torch.cuda.synchronize()

    def same(a, b, what):
        a, b = a.cpu(), b.cpu()
        if a.dtype.is_floating_point:
            torch.testing.assert_close(a, b, rtol=E2E_RTOL, atol=E2E_ATOL, msg=lambda m: f"{label} "
                                       f"{what}: {m}")
        elif not torch.equal(a, b):
            raise AssertionError(f"{label}: {what} differ on the card")

    for i, ((s_cpu, t_cpu), (s_gpu, t_gpu)) in enumerate(zip(*runs)):
        for name, a in s_gpu._asdict().items():
            same(a, getattr(s_cpu, name), f"step {i} state {name}")
        for name in ("obs", "share_obs", "rewards", "dones", "bad_transition"):
            same(getattr(t_gpu, name), getattr(t_cpu, name), f"step {i} {name}")
        for k, v in (t_gpu.metrics or {}).items():
            same(v, t_cpu.metrics[k], f"step {i} {k}")
    log(f"small {label} run (a reset and {steps} steps of {n_envs} envs): card == CPU (flags and "
        f"integers equal, floats at rtol {E2E_RTOL}, atol {E2E_ATOL})")
    return [s for s, _ in runs[0]]


def check_slice8_against_cpu(devices=("cpu", "cuda")) -> None:
    """Phase 17 (e): a Humanoid 17x1 HAPPO iteration through unhealthy
    terminations, a HumanoidStandup reset and 4 steps, a TwoCatchUnderarm
    HAPPO iteration with both objects in contact, a MetaMT4 reset that draws
    several layouts, a DoorOpenOutward HASAC block and an Allegro reset and
    4 steps, on the card against the CPU."""
    check_walker_against_cpu(devices, "humanoid 17x1",
                             {"scenario": "Humanoid-v2", "agent_conf": "17x1",
                              "obs_standardize": False}, lift_humanoid)
    check_env_against_cpu("humanoidstandup 17x1", "mamujoco_jax",
                          {"scenario": "HumanoidStandup-v2", "agent_conf": "17x1"}, 4,
                          devices, n_envs=8)
    check_walker_against_cpu(devices, "twocatchunderarm", {"task": "ShadowHandTwoCatchUnderarm"},
                             collide_objects, env="dexhands_jax", unhealthy=False)
    states = check_env_against_cpu("metamt4", "dexhands_jax", {"task": "ShadowHandMetaMT4"}, 2,
                                   devices)
    layouts = set(states[0].layout.tolist())
    if len(layouts) < 2:
        raise AssertionError(f"metamt4: the reset drew the layouts {layouts} only")
    check_off_policy_against_cpu("hasac", devices, make=small_dexhands_hasac_runner,
                                 label="hasac dexhands door (hinge)")
    check_env_against_cpu("allegrohandover", "dexhands_jax", {"task": "AllegroHandOver"}, 4,
                          devices)


# ----------------- academy soccer, air combat, swimmer and ants (phase 18)
SOCCER_HAPPO = "tuned_configs/football_jax/academy_3_vs_1_with_keeper/happo/config.json"
AIRCOMBAT_HAPPO = "tuned_configs/lag_jax/2v2/happo/config.json"
SWIMMER_HASAC = "tuned_configs/mamujoco_jax/manyagent_swimmer-10x2/hasac/config.json"
# (label, config, iterations or blocks, agents, off-policy, evaluate)
SOCCER_PATH = (("soccer_happo", SOCCER_HAPPO, 2, 3, False, True),)
SLICE9_PATHS = (("aircombat_happo", AIRCOMBAT_HAPPO, 2, 2, False, False),
                ("swimmer_hasac", SWIMMER_HASAC, 2, 10, True, False))
# the soccer evaluation, cut from the config's 20 episodes
SOCCER_EVAL_EPISODES = 10


def soccer_ends_watch() -> Watch:
    """How the soccer episodes of a run ended: goal, lost possession, ball
    out, timeout; at least one end that is not a timeout is required."""
    from harl_tpu_torch.envs.football_jax.soccer import AcademySoccer

    def read(env, args, out):
        state, ts = out
        done = ts.dones[:, 0]
        goal = ts.metrics["won"] > 0
        lost = (state.owner == 2) & ~goal
        timeout = ts.bad_transition
        ball_out = done & ~goal & ~lost & ~timeout
        return torch.stack([goal.sum(), lost.sum(), ball_out.sum(), timeout.sum()])

    def report(totals):
        if not totals or sum(totals[:3]) < 1:
            raise AssertionError(f"no soccer episode ended before its time limit: {totals}")
        return "episode ends: {} goals, {} lost, {} out, {} timeouts".format(*totals)

    return Watch(AcademySoccer, "step", read, report)


def downed_watch() -> Watch:
    """Aircraft shot down or flown out of the altitude band in a run:
    allies and enemies; at least one is required."""
    from harl_tpu_torch.envs.lag_jax.aircombat import AirCombat

    def read(env, args, out):
        gone = args[0].alive & ~out[0].alive
        N = env.n_allies
        return torch.stack([gone[:, :N].sum(), gone[:, N:].sum()])

    def report(totals):
        if not totals or sum(totals) < 1:
            raise AssertionError("no aircraft was downed")
        return f"aircraft downed: {totals[0]} allies, {totals[1]} enemies"

    return Watch(AirCombat, "step", read, report)


def drive_slice9_paths(card: str, log_dir: str, floor: dict, shrink: dict = None) -> tuple:
    """Phase 18 (a)-(c): the tuned configs as they are (only iterations or
    blocks cut) through ``harl_tpu_torch.train.main``: (a) HAPPO on academy
    3_vs_1_with_keeper (1024 envs x 128 steps, [128, 128]), 2 iterations and
    an evaluation of ``SOCCER_EVAL_EPISODES`` episodes (the config asks 20),
    an episode end other than a timeout required; (b) HAPPO on 2v2 air
    combat (1024 x 128, MultiDiscrete(11, 11, 10)), 2 iterations, a downed
    aircraft required; each then one more rollout on whose GAE inputs
    (T=128, b=1024) the kernel is held against its plain version and timed;
    (c) HASAC on manyagent_swimmer 10x2 (20 envs, buffer 1,000,000 rows), its
    10,000-step warmup and 2 blocks. Returns (the launches by path: GAE once
    an iteration on (a) and (b), none on (c); the GAE kernel's numbers on the
    inputs of (a) and (b); a function that counts the device ops of one env
    step of each new env, for ``main`` to call after every timed run)."""
    last = {}
    by_path = drive_tuned_paths(card, log_dir, SOCCER_PATH,
                                {**(shrink or {}), "eval_episodes": SOCCER_EVAL_EPISODES},
                                {"soccer_happo": (soccer_ends_watch,)}, last)
    by_path.update(drive_tuned_paths(card, log_dir, SLICE9_PATHS, shrink,
                                     {"aircombat_happo": (downed_watch,)}, last))
    in_situ = {}
    for label in ("soccer_happo", "aircombat_happo"):
        runner, state = last[label]
        T, n = runner.episode_length, runner.n_rollout_threads
        in_situ[label] = gae_in_situ(label.replace("_", " "), runner, state, (T, n, 1), floor,
                                     card)

    def profile(device="cuda"):
        from harl_tpu_torch.envs import make_env
        from harl_tpu_torch.envs.core import VecEnv
        from harl_tpu_torch.utils import spaces
        from harl_tpu_torch.utils.noise import GeneratorNoise

        for label, env_name, args, X in (
                ("soccer 3_vs_1", "football_jax", {}, 1024),
                ("soccer 3_vs_1 pixels", "football_jax", {"representation": "pixels"}, 1024),
                ("aircombat 2v2", "lag_jax", {}, 1024),
                ("manyagent_swimmer 10x2", "mamujoco_jax",
                 {"scenario": "manyagent_swimmer", "agent_conf": "10x2"}, 20),
                ("reacher 2x1", "mamujoco_jax", {"scenario": "Reacher-v2"}, 256),
                ("coupled_half_cheetah", "mamujoco_jax", {"scenario": "coupled_half_cheetah"},
                 256),
                ("manyagent_ant 2x3", "mamujoco_jax",
                 {"scenario": "manyagent_ant", "agent_conf": "2x3"}, 256)):
            env = make_env(env_name, args, device)
            vec = VecEnv(env, X)
            noise = GeneratorNoise(torch.Generator(device=device).manual_seed(0), device)
            st, _ = vec.reset(noise)
            sp = env.action_space[0]
            if spaces.space_kind(sp) == "Box":
                actions = torch.zeros((X, env.n_agents, sp.shape[0]), device=device)
            else:
                actions = torch.zeros((X, env.n_agents, sp.shape[0]), dtype=torch.long,
                                      device=device)
            step_ops, step_ms = count_device_ops(lambda: env.step(st, actions))
            vec_ops, vec_ms = count_device_ops(lambda: vec.step(st, actions, noise))
            print(f"{label} device ops ({X} envs): one env step {step_ops} ops, {step_ms:.3f} ms "
                  f"device time; with the auto-reset {vec_ops} ops, {vec_ms:.3f} ms, on {card}",
                  flush=True)

    return by_path, in_situ, profile


def dogfight(env):
    """Air combat: in half the envs every aircraft within ~800 m of the
    others at random headings, so that the guns engage."""
    g = torch.Generator().manual_seed(3)
    pos = env.pos.clone()
    n = pos[::2].shape[:2]
    pos[::2, :, :2] = (torch.rand(n + (2,), generator=g) * 1600.0 - 800.0).to(pos.device)
    psi = env.psi.clone()
    psi[::2] = (torch.rand(n, generator=g) * 6.2832 - 3.1416).to(psi.device)
    return env._replace(pos=pos, psi=psi)


def small_aircombat_hasac_runner(algo: str, device, noise):
    """MultiDiscrete HASAC on 2v2 air combat at small widths: the block
    sizes of ``small_off_policy_runner``, episodes of 5 steps, auto-α."""
    from harl_tpu_torch.runners.off_policy import OffPolicyRunner
    from harl_tpu_torch.utils.config_tools import get_defaults_yaml_args

    algo_args, _ = get_defaults_yaml_args(algo, "lag_jax")
    algo_args["train"].update(n_rollout_threads=16, num_env_steps=10 ** 9, warmup_steps=32,
                              train_interval=4, update_per_train=1)
    algo_args["algo"].update(batch_size=64, buffer_size=1000, n_step=3, auto_alpha=True)
    algo_args["model"].update(hidden_sizes=[16, 16])
    return OffPolicyRunner({"algo": algo, "env": "lag_jax"}, algo_args,
                           {"scenario": "2v2", "episode_limit": 5}, device=device, noise=noise)


def check_slice9_against_cpu(devices=("cpu", "cuda")) -> None:
    """Phase 18 (d): small HAPPO iterations of academy soccer (``simple``,
    and ``pixels`` through ``CNNBase``) and 2v2 air combat (MultiDiscrete,
    half the envs in a dogfight), a MultiDiscrete HASAC block on air combat,
    and resets and steps of the manyagent swimmer, Reacher,
    coupled_half_cheetah and the manyagent ant, on the card against the CPU."""
    same = lambda env: env
    for label, args in (("soccer 3_vs_1", {"env_name": "academy_3_vs_1_with_keeper"}),
                        ("soccer pixels", {"env_name": "academy_pass_and_shoot_with_keeper",
                                           "representation": "pixels"})):
        check_walker_against_cpu(devices, label, {**args, "episode_limit": 8}, same,
                                 env="football_jax", unhealthy=False)
    check_walker_against_cpu(devices, "aircombat 2v2", {"scenario": "2v2", "episode_limit": 8},
                             dogfight, env="lag_jax", unhealthy=False)
    check_off_policy_against_cpu("hasac", devices, make=small_aircombat_hasac_runner,
                                 label="MultiDiscrete hasac aircombat 2v2")
    for label, args, steps in (
            ("manyagent_swimmer 10x2", {"scenario": "manyagent_swimmer", "agent_conf": "10x2",
                                        "episode_limit": 3}, 5),
            ("reacher 2x1", {"scenario": "Reacher-v2", "episode_limit": 3}, 5),
            ("coupled_half_cheetah", {"scenario": "coupled_half_cheetah", "episode_limit": 3}, 5),
            ("manyagent_ant 2x3", {"scenario": "manyagent_ant", "agent_conf": "2x3",
                                   "episode_limit": 3}, 5)):
        check_env_against_cpu(label, "mamujoco_jax", args, steps, devices, n_envs=8)

# ------------------------------------------ data parallelism (phase 19)
# the order of float sums: a rank sums its rows, the all-reduce adds the
# ranks' sums
DP_RTOL, DP_ATOL = 1e-5, 1e-6
# on-policy parameters and Adam moments after an iteration, against the
# one-rank update of the ranks' own rows: Adam (eps 1e-5) carries the sums'
# rounding into a parameter by up to lr/eps times a gradient's difference a
# step (8.3e-7 read for HalfCheetah, 2.0e-6 for SMACLite on the H100),
# while one Adam step moves it by up to lr (5e-4)
DP_PARAM_ATOL = 1e-5


class DPWorkload(NamedTuple):
    """A data-parallel workload: ``make(device)`` builds its runner (a
    module-level function or a ``functools.partial`` of one, so that it
    pickles to a spawned rank); ``steps``, the kinds of the steps held
    against the one-rank run, each from that run's state before it
    ("iteration", "warmup", "collect" or "train"); ``pre``, the kinds the
    one-rank run takes before its first step."""
    make: Callable
    steps: tuple
    pre: tuple = ()

    @property
    def off_policy(self) -> bool:
        return "iteration" not in self.steps


# Phase 19's workloads at full width on the card: HAPPO HalfCheetah-6x1
# (4096 envs x 32 steps, [64, 64]), 2 iterations; HAPPO SMACLite 5m_vs_6m FP
# GRU at the bench's widths (256 envs x 70 steps), 1 iteration; HASAC
# HalfCheetah-6x1 at the bench's widths (256 envs, blocks of 50, batch 1000,
# buffer 200,000) after its warmup and a first collect, cut into a train
# block, a collect and a train block
DP_WORKLOADS = {
    "halfcheetah": DPWorkload(functools.partial(make_runner, MAIN["n_envs"],
                                                MAIN["episode_length"], MAIN["hidden"]),
                              ("iteration",) * 2),
    "smaclite_fp": DPWorkload(functools.partial(make_smaclite_runner, SMAC["n_envs"],
                                                SMAC["episode_length"], SMAC["hidden"]),
                              ("iteration",)),
    "hasac": DPWorkload(functools.partial(make_off_policy_runner, "hasac"),
                        ("train", "collect", "train"), ("warmup", "collect")),
}


def sync(device) -> None:
    """Wait for ``device``'s queue: a CUDA device's; nothing on the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def dp_step(runner, state, kind: str) -> tuple:
    """One step of ``kind`` from ``state``: (state, its metrics)."""
    if kind == "warmup":
        return runner.warmup_block(state), {}
    return getattr(runner, {"iteration": "train_iteration", "train": "train_block",
                            "collect": "collect_block"}[kind])(state)


class FirstGrads:
    """Within a ``with``: each optimizer's gradients when its first step
    returns (summed over the ranks, and clipped where the optimizer clips),
    in the order the optimizers first step."""

    def __init__(self):
        self.grads, self.seen, self.orig = [], set(), {}

    def __enter__(self):
        from harl_tpu_torch.algos.common import ClippedAdam, MeshAdam

        for cls in (ClippedAdam, MeshAdam):
            orig = self.orig[cls] = cls.step

            def step(opt, *args, _orig=orig, **kwargs):
                out = _orig(opt, *args, **kwargs)
                if id(opt) not in self.seen:
                    self.seen.add(id(opt))
                    params = (opt.params if isinstance(opt, ClippedAdam)
                              else [p for g in opt.param_groups for p in g["params"]])
                    self.grads.append([p.grad.detach().cpu().clone() for p in params
                                       if p.grad is not None])
                return out

            cls.step = step
        return self

    def __exit__(self, *exc):
        for cls, orig in self.orig.items():
            cls.step = orig


def inserted_rows(spy: Spy) -> list:
    """The rows of each replay insert a ``Spy`` on ``insert`` saw, on the
    CPU: per env step, the batch's tensors in ``tensors_of`` order."""
    from harl_tpu_torch.parallel.mesh import tensors_of

    return [[t.cpu() for t in tensors_of(args[0])] for _, _, args, _ in spy.calls]


class UpdateInputs:
    """Within a ``with``: what each on-policy ``update_phase`` is given as
    it begins, on the CPU (the rollout's time-major data and the carry's
    last rows; the train state aside), and the generator's state then."""

    def __enter__(self):
        from harl_tpu_torch.parallel.mesh import map_tensors
        from harl_tpu_torch.runners.on_policy import OnPolicyRunner

        self.calls, orig = [], OnPolicyRunner.update_phase
        self.orig = orig

        def update_phase(runner, state, *args):
            self.calls.append(dict(generator=runner.generator.get_state().clone(),
                                   args=map_tensors(lambda t: t.detach().cpu().clone(), args)))
            return orig(runner, state, *args)

        OnPolicyRunner.update_phase = update_phase
        return self

    def __exit__(self, *exc):
        from harl_tpu_torch.runners.on_policy import OnPolicyRunner

        OnPolicyRunner.update_phase = self.orig


def dp_drive(label: str, mesh, card: str, states: list, floor: dict = None,
             workload: DPWorkload = None, device="cuda") -> dict:
    """One workload (``DP_WORKLOADS[label]`` unless ``workload`` is given)
    on this process, on its rank's env columns under ``mesh`` (none: the
    one-rank run on ``device``), its ``steps``. Every step starts from the
    one-rank run's state before it, through the checkpoint paths
    ``states``: the one-rank run, after its ``pre`` steps, saves it there,
    every rank resumes from it. After each step: the state's replicated
    tensors (networks, moments, ValueNorm, α; on the CPU), the replicas'
    mismatch over the ranks, the host's seconds, GAE launches, the
    all-reduces and their milliseconds (CUDA events); every optimizer's
    first-step gradients (``FirstGrads``); a train block's first critic
    loss (this rank's share); a warmup's or collect's inserted rows (global
    rows under a mesh); an iteration's update inputs (``UpdateInputs``,
    this rank's columns). On-policy with ``floor``, then one more rollout
    on whose GAE inputs (this rank's columns) the kernel is held against
    its plain version and timed (``gae_in_situ``)."""
    from harl_tpu_torch.buffers.off_policy import ReplayBuffer
    from harl_tpu_torch.runners import common
    from harl_tpu_torch.runners.off_policy import OffPolicyRunner

    w = workload or DP_WORKLOADS[label]
    runner = w.make(device if mesh is None else mesh.device)
    runner.use_mesh(mesh)
    mesh, dev = runner.mesh, runner.device
    if mesh.grouped:
        # one untimed all-reduce first: NCCL sets up its communicator there
        mesh.all_reduce_sum([torch.zeros(1, device=dev)])
        mesh.time_collectives = True
        mesh.collective_ms()
    state = runner.init_state(0)
    if not mesh.grouped:
        for kind in w.pre:
            state, _ = dp_step(runner, state, kind)
    sync(dev)
    zero_launches()
    steps = []
    for path, kind in zip(states, w.steps):
        if mesh.grouped:
            state = runner.load_checkpoint(state, torch.load(path, map_location=dev,
                                                             weights_only=True))
        else:
            torch.save(runner.checkpoint(state), path)
        calls = mesh.calls
        first, updates = FirstGrads(), Spy(OffPolicyRunner, "update", sync=False,
                                           keep=lambda loss: float(loss))
        inserts, inputs = Spy(ReplayBuffer, "insert", sync=False), UpdateInputs()
        sync(dev)
        t0 = time.perf_counter()
        with first, updates, inserts, inputs:
            state, m = dp_step(runner, state, kind)
        sync(dev)
        sec = time.perf_counter() - t0
        tensors = common.replica_tensors(state, buffer=False)
        steps.append(dict(
            kind=kind, seconds=sec, launches=read_launches(),
            tensors=[t.detach().cpu().clone() for t in tensors], names=replica_names(state),
            metrics={k: float(v) for k, v in m.items() if torch.is_tensor(v) and v.dim() == 0},
            collective_ms=mesh.collective_ms(), collectives=mesh.calls - calls,
            mismatch=mesh.replica_mismatch(common.replica_tensors(state)),
            first_grads=first.grads, first_loss=updates.calls[0][3] if updates.calls else None,
            inserts=inserted_rows(inserts), update_inputs=inputs.calls))
    out = dict(steps=steps, env_steps=(runner.train_interval if w.off_policy
                                       else runner.episode_length) * runner.n_envs)
    if not w.off_policy and floor is not None:
        T, n = runner.episode_length, runner.n_envs
        shape = (T, n, runner.n_agents, 1) if runner.fp else (T, n, 1)
        out["gae"] = gae_in_situ(f"{label} rank {mesh.rank}", runner, state, shape, floor,
                                 card)
    return out


def dp_rank(mesh, card: str, floor: dict, states: dict, workloads: dict = None) -> dict:
    """Phase 19 (b) on one spawned rank: every workload of ``workloads``
    (``DP_WORKLOADS``) in turn, each step from the one-rank run's state
    before it (``states`` by workload)."""
    return {label: dp_drive(label, mesh, card, states[label], floor, w)
            for label, w in (workloads or DP_WORKLOADS).items()}


def replayed_collect(rank: int, world: int, path: str, workload: DPWorkload, device,
                     kind: str = "collect") -> list:
    """Rank ``rank`` of ``world``'s warmup or collect block (``kind``)
    replayed in this process without a process group, from the checkpoint
    at ``path``: its env columns, its cut of every global draw, the rows it
    inserts (its own only: nothing gathers them)."""
    from harl_tpu_torch.buffers.off_policy import ReplayBuffer
    from harl_tpu_torch.parallel.mesh import Mesh

    runner = workload.make(device)
    runner.use_mesh(Mesh(rank, world, device, grouped=False))
    state = runner.load_checkpoint(runner.init_state(0), torch.load(
        path, map_location=runner.device, weights_only=True))
    with Spy(ReplayBuffer, "insert", sync=False) as inserts:
        dp_step(runner, state, kind)
    return inserted_rows(inserts)


def join_env_axis(parts: list):
    """The ranks' update inputs (``UpdateInputs`` args, in rank order) as
    one rank's: the rollout's time-major data joined on axis 1, the carry's
    rows on axis 0 (env-major, FP critic rows included)."""
    from harl_tpu_torch.parallel.mesh import map_tensors, tensors_of

    data = [p[0] for p in parts]
    flat = [tensors_of(d) for d in data]
    joined = iter([torch.cat(ts, dim=1) for ts in zip(*flat)])
    rest = [None if p[0] is None else torch.cat(p) for p in zip(*(q[1:] for q in parts))]
    return (map_tensors(lambda _: next(joined), data[0]), *rest)


def replayed_update(path: str, calls: list, workload: DPWorkload, device) -> dict:
    """The one-rank run's update of the very rows the ranks collected: from
    the one-rank state at ``path``, ``update_phase`` on the ranks' inputs
    (their ``UpdateInputs`` calls, in rank order) joined into the whole
    batch, with the generator as the ranks had it. Its first-step gradients
    and replicated tensors, in ``dp_drive``'s step form."""
    from harl_tpu_torch.parallel.mesh import map_tensors
    from harl_tpu_torch.runners import common

    runner = workload.make(device)
    state = runner.load_checkpoint(runner.init_state(0), torch.load(
        path, map_location=runner.device, weights_only=True))
    runner.generator.set_state(calls[0]["generator"])
    args = map_tensors(lambda t: t.to(runner.device), join_env_axis([c["args"] for c in calls]))
    with FirstGrads() as first:
        runner.update_phase(state, *args)
    tensors = common.replica_tensors(state, buffer=False)
    return dict(first_grads=first.grads, first_loss=None, names=replica_names(state),
                tensors=[t.detach().cpu().clone() for t in tensors], metrics={})


def replica_names(state) -> list:
    """The path of each tensor of ``replica_tensors(state, buffer=False)``."""
    from harl_tpu_torch.utils import checkpoint

    names = []

    def walk(x, path):
        if isinstance(x, torch.Tensor):
            names.append(path)
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}.{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{path}[{i}]")

    for k, v in checkpoint.to_payload(state).items():
        if k not in ("carry", "buffer"):
            walk(v, k)
    return names


def dp_compare_first(label: str, got: dict, ref: dict, check: bool = True) -> None:
    """What the data-parallel arithmetic changes, before Adam amplifies it:
    at every step (each from the one-rank run's state), every optimizer's
    first-step gradients (summed over the ranks) against ``ref``'s at
    DP_RTOL, DP_ATOL; with ``check`` false, only reported."""
    worst = 0.0
    for i, (s, r) in enumerate(zip(got["steps"], ref["steps"])):
        a, b = s["first_grads"], r["first_grads"]
        if len(a) != len(b) or any(len(x) != len(y) for x, y in zip(a, b)):
            raise AssertionError(f"{label} step {i + 1}: first-step gradients of another "
                                 "structure")
        for xs, ys in zip(a, b):
            for x, y in zip(xs, ys):
                if check:
                    torch.testing.assert_close(
                        x, y, rtol=DP_RTOL, atol=DP_ATOL,
                        msg=lambda m: f"{label} step {i + 1}: first-step gradients: {m}")
                if x.numel():
                    worst = max(worst, float((x - y).abs().max()))
    n = max(len(s["first_grads"]) for s in got["steps"])
    print(f"{label}: every step's first-step gradients of {n} optimizers "
          + (f"equal (rtol {DP_RTOL}, atol {DP_ATOL}; " if check else "reported (") +
          f"max |Δ| {worst:.3g})", flush=True)


def dp_compare(label: str, got: dict, ref: dict, rtol: float, atol: float,
               check: bool = True) -> float:
    """Every step's replicated tensors against the one-rank run's; returns
    the largest |Δ|. With ``check`` false, only reported."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(got["steps"], ref["steps"])):
        if len(a["tensors"]) != len(b["tensors"]):
            raise AssertionError(f"{label}: {len(a['tensors'])} tensors against "
                                 f"{len(b['tensors'])}")
        kinds = {}
        for name, x, y in zip(b.get("names") or [""] * len(b["tensors"]), a["tensors"],
                              b["tensors"]):
            if not x.numel():
                continue
            if not x.dtype.is_floating_point:
                if not torch.equal(x, y):
                    raise AssertionError(f"{label} step {i + 1}: {name} differs")
                continue
            kind = name.rsplit(".", 1)[-1] if "exp_avg" in name else "parameters and rest"
            d = (x - y).abs()
            k = kinds.setdefault(kind, [0.0, 0.0, ""])
            share = float((d / (atol + rtol * y.abs())).max())
            if check and share > 1:
                raise AssertionError(f"{label} step {i + 1}: {name} |Δ| {float(d.max()):.3g} "
                                     f"past rtol {rtol}, atol {atol}")
            if share > k[1]:
                k[:] = [max(k[0], float(d.max())), share, name]
            k[0] = max(k[0], float(d.max()))
        print(f"{label} step {i + 1}: " + "; ".join(
            f"{kind} max |Δ| {v[0]:.3g}, worst {v[1]:.3g} of the tolerance ({v[2]})"
            for kind, v in kinds.items()) + f" (rtol {rtol}, atol {atol})", flush=True)
        worst = max([worst] + [v[0] for v in kinds.values()])
        for k in ("episode_count",):
            if k in b["metrics"] and a["metrics"][k] != b["metrics"][k]:
                raise AssertionError(f"{label} step {i + 1}: {k} {a['metrics'][k]} against "
                                     f"{b['metrics'][k]}")
    return worst


def same_bits(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Whether two tensors hold the same bits (-0.0 is not 0.0)."""
    return x.dtype == y.dtype and x.shape == y.shape and torch.equal(
        x.contiguous().reshape(-1).view(torch.uint8), y.contiguous().reshape(-1).view(torch.uint8))


def rows_apart(a: list, b: list) -> list:
    """Per env step, the largest |Δ| between two runs' inserted rows."""
    return [max((float((x - y).abs().max()) for x, y in zip(xs, ys) if x.numel()),
                default=0.0) for xs, ys in zip(a, b)]


def check_gathered_collect(ranks: list, ref: dict, states: list, card: str, label: str,
                           workload: DPWorkload, device, tag: str) -> None:
    """Every warmup and collect step of an off-policy workload on the
    ranks, against (1) each rank's share of it replayed here without a
    process group (its columns, its cut of the draws, at its width): the
    gathered rows must be the replays' rows in rank order, bitwise; and (2)
    the one-rank run's step from the same state, at the whole width:
    reported, the width's own rounding."""
    world = len(ranks)
    for i, kind in enumerate(workload.steps):
        if kind not in ("warmup", "collect"):
            continue
        got = ranks[0][label]["steps"][i]["inserts"]
        replays = [replayed_collect(r, world, states[i], workload, device, kind)
                   for r in range(world)]
        if len(got) != len(replays[0]):
            raise AssertionError(f"{tag} {label}: {len(got)} inserts against {len(replays[0])}")
        for t, rows in enumerate(got):
            want = [torch.cat(parts) for parts in zip(*(rp[t] for rp in replays))]
            if not all(same_bits(x, y) for x, y in zip(rows, want)):
                raise AssertionError(f"{tag} {label}: the gathered rows of env step {t + 1} of "
                                     f"its {kind} are not the ranks' replayed rows")
        apart = rows_apart(got, ref[label]["steps"][i]["inserts"])
        print(f"{tag} {label}: the {kind}'s {len(got)} gathered inserts (step {i + 1}) equal, "
              f"bit for bit, each rank's {got[0][0].shape[0] // world} columns replayed without "
              f"a process group; against the one-rank run's {got[0][0].shape[0]}-wide {kind} "
              f"from the same state (the width's rounding, not the gather): max |Δ| "
              f"{apart[0]:.3g} after env step 1, {max(apart[:10]):.3g} by step "
              f"{min(10, len(apart))}, {max(apart):.3g} by step {len(apart)} on {card}",
              flush=True)


def step_seconds(r: dict) -> float:
    """Seconds of a workload's timed steps: the steps after the first where
    there are several (the first may pay warm-up; for HASAC, its second
    block, a collect and a train block)."""
    steps = r["steps"][1:] if len(r["steps"]) > 1 else r["steps"]
    return sum(s["seconds"] for s in steps)


def step_env_steps(workload: DPWorkload, r: dict) -> int:
    """Env-steps of the steps ``step_seconds`` times."""
    if workload.off_policy:
        return r["env_steps"] * sum(s["kind"] == "collect" for s in r["steps"][1:])
    return r["env_steps"] * max(len(r["steps"]) - 1, 1)


def gae_expected(workload: DPWorkload, step: int, device) -> dict:
    """The kernels' launches after ``step`` steps (from 1) of a workload on
    ``device``: GAE once an on-policy iteration on a card, else none."""
    on_card = torch.device(device).type == "cuda" and not workload.off_policy
    return {"gae": step if on_card else 0, "discounted_returns": 0}


def dp_reference(card: str, log_dir: str, workloads: dict, device="cuda") -> tuple:
    """The one-rank runs without a mesh on ``device``: (the paths of the
    states each step starts from, by workload; the runs)."""
    os.makedirs(log_dir, exist_ok=True)
    states = {label: [os.path.join(log_dir, f"{label}_state{i}.pt")
                      for i in range(len(w.steps))] for label, w in workloads.items()}
    ref = {label: dp_drive(label, None, card, states[label], None, w, device)
           for label, w in workloads.items()}
    for label, r in ref.items():
        for i, st in enumerate(r["steps"]):
            if st["launches"] != gae_expected(workloads[label], i + 1, device):
                raise AssertionError(f"one-rank {label}: launches {st['launches']}")
    return states, ref


def dp_check_ranks(card: str, ranks: list, states: dict, ref: dict, workloads: dict, device,
                   tag: str, where: str) -> tuple:
    """The ranks' ``dp_rank`` results held against the one-rank runs
    ``ref`` (``dp_reference``): the replicas bitwise equal after every step,
    finite losses and statistics, the kernels' launches; on-policy, every
    iteration's first-step gradients and, within DP_PARAM_ATOL, the
    parameters equal to the one-rank update of the ranks' own rows
    (``replayed_update``), against the one-rank run reported; off-policy,
    the train blocks' first-step gradients and first critic losses equal
    to the one-rank run's, its parameters reported, its gathered warmups
    and collects bitwise equal to the ranks' replayed shares. ``device``
    is the one-rank runs' and the replays'. Returns (launches by rank and
    workload, the GAE kernel's in-situ numbers by rank and workload, rates by workload:
    env-steps/s over all ranks and one-rank, each rank's seconds a step)."""
    from harl_tpu_torch.parallel.mesh import tensors_of

    world = len(ranks)
    by_path, in_situ, rates = {}, {}, {}
    for label, w in workloads.items():
        seconds, worst, apart = [], {"held": 0.0, "one-rank": 0.0}, 0.0
        if w.off_policy:
            # its train blocks start from the one-rank run's state and buffer
            held = ref[label]
        else:
            # the one-rank update of the very rows the ranks collected: the
            # one-rank run's own rollout, at another width, rounds apart
            calls = [[res[label]["steps"][i]["update_inputs"][0] for res in ranks]
                     for i in range(len(states[label]))]
            held = dict(steps=[replayed_update(path, c, w, device)
                               for path, c in zip(states[label], calls)])
            for c, st in zip(calls, ref[label]["steps"]):
                mine = tensors_of(join_env_axis([x["args"] for x in c]))
                theirs = tensors_of(st["update_inputs"][0]["args"])
                apart = max([apart] + [float((x - y).abs().max()) for x, y in zip(mine, theirs)
                                       if x.numel()])
        for rank, res in enumerate(ranks):
            r = res[label]
            for i, st in enumerate(r["steps"]):
                if st["mismatch"] != (0, 0.0):
                    raise AssertionError(f"{tag} {label} rank {rank} step {i + 1}: replicas "
                                         f"differ {st['mismatch']}")
                bad = {k: v for k, v in st["metrics"].items() if not math.isfinite(v)}
                if bad:
                    raise AssertionError(f"{tag} {label} rank {rank} step {i + 1}: {bad}")
                if st["launches"] != gae_expected(w, i + 1, device):
                    raise AssertionError(f"{tag} {label} rank {rank}: launches {st['launches']}")
            name = f"{tag} {label} rank {rank}"
            dp_compare_first(name if w.off_policy else
                             f"{name} against the one-rank update of its rows", r, held)
            if w.off_policy:
                # Adam with eps 1e-8 moves a parameter by ±lr wherever its
                # gradient is rounding noise, whichever the sign: reported
                worst["one-rank"] = max(worst["one-rank"], dp_compare(
                    name, r, ref[label], DP_RTOL, DP_PARAM_ATOL, check=False))
            else:
                worst["held"] = max(worst["held"], dp_compare(
                    f"{name} against the one-rank update of its rows", r, held, DP_RTOL,
                    DP_PARAM_ATOL))
                dp_compare_first(f"{name} against the one-rank run", r, ref[label],
                                 check=False)
                worst["one-rank"] = max(worst["one-rank"], dp_compare(
                    f"{name} against the one-rank run", r, ref[label], DP_RTOL, DP_PARAM_ATOL,
                    check=False))
            by_path[f"rank{rank}_{label}"] = r["steps"][-1]["launches"]
            if "gae" in r:
                in_situ[f"{label}_rank{rank}"] = r["gae"]
            seconds.append([st["seconds"] for st in r["steps"]])
        for i, st in enumerate(ref[label]["steps"]):
            if st["first_loss"] is not None:
                # the ranks' shares of a train block's first critic loss
                loss = sum(res[label]["steps"][i]["first_loss"] for res in ranks)
                if not math.isclose(loss, st["first_loss"], rel_tol=DP_RTOL):
                    raise AssertionError(f"{tag} {label} step {i + 1}: first critic loss "
                                         f"{loss} against {st['first_loss']}")
        if w.off_policy:
            check_gathered_collect(ranks, ref, states[label], card, label, w, device, tag)
        r0 = ranks[0][label]
        timed = [sum(s[1:] if len(s) > 1 else s) for s in seconds]
        rates[label] = dict(
            env_steps_per_s=world * step_env_steps(w, r0) / max(timed),
            one_rank_env_steps_per_s=step_env_steps(w, ref[label]) / step_seconds(ref[label]),
            seconds=seconds, one_rank_seconds=[st["seconds"] for st in ref[label]["steps"]],
            collectives=[st["collectives"] for st in r0["steps"]],
            collective_ms=[st["collective_ms"] for st in r0["steps"]])
        secs = ", ".join("%.4f s" % st["seconds"] for st in r0["steps"])
        colls = ", ".join("%d (%.3f ms)" % (st["collectives"], st["collective_ms"])
                          for st in r0["steps"])
        spread = max(max(s[i] for s in seconds) - min(s[i] for s in seconds)
                     for i in range(len(seconds[0])))
        held = (f"parameters reported (max |Δ| {worst['one-rank']:.3g})" if w.off_policy
                else f"parameters within rtol {DP_RTOL}, atol {DP_PARAM_ATOL} of the one-rank "
                f"update of the ranks' rows (max |Δ| {worst['held']:.3g}); against the one-rank "
                f"run, whose rollout at another width may round apart (its update inputs max "
                f"|Δ| {apart:.3g}), reported (max |Δ| {worst['one-rank']:.3g})")
        print(f"{tag} {label}: {where}, {r0['env_steps']} env-steps a rank a "
              f"{'block' if w.off_policy else 'iteration'}, each of its steps "
              f"({', '.join(w.steps)}) from the one-rank run's state; replicas bitwise equal "
              f"after each of {len(r0['steps'])}; {held}; "
              f"{rates[label]['env_steps_per_s']:.1f} env-steps/s over the {world} ranks against "
              f"{rates[label]['one_rank_env_steps_per_s']:.1f} one-rank; per step {secs} on rank "
              f"0, the ranks' walls at most {spread:.4f} s apart; all-reduces and the time in "
              f"them per step {colls} on rank 0; {card}", flush=True)
    return by_path, in_situ, rates


def drive_dp_paths(card: str, floor: dict, log_dir: str) -> tuple:
    """Phase 19 (a)-(c) and (e). (a) HalfCheetah-6x1 HAPPO at 4096 x 32
    through ``OnPolicyRunner.run(mesh=…)`` over a world-1 NCCL group, 2
    iterations, bitwise equal to the same run without a mesh; (b) 2 ranks
    spawned on the one card (gloo over CUDA tensors): HalfCheetah HAPPO
    (2048 envs a rank), SMACLite 5m_vs_6m FP GRU HAPPO (128 a rank) and
    HASAC at the bench's widths, each step from the one-rank run's state,
    held by ``dp_check_ranks``; GAE once an iteration on each rank and held
    against its plain version on that rank's inputs; (c) the CLI:
    ``--platform cpu --n_devices 2`` on a tiny MPE HAPPO run, and the tuned
    HalfCheetah-2x3 MAPPO (share_param) with ``--n_devices 1`` on the card;
    (e) env-steps/s of (a), (b) and the one-rank runs, and the milliseconds
    an iteration or block spends in collectives. Returns (launches by path,
    the GAE kernel's in-situ numbers by rank and workload)."""
    from harl_tpu_torch import train
    from harl_tpu_torch.parallel import mesh as dpmesh
    from harl_tpu_torch.parallel.launch import free_port, spawn_ranks
    from harl_tpu_torch.runners import common

    by_path = {}
    states, ref = dp_reference(card, log_dir, DP_WORKLOADS)
    # (a) a world-1 NCCL group through run(mesh=…)
    zero_launches()
    dpmesh.distributed_init(f"localhost:{free_port()}", 1, 0, "nccl")
    try:
        mesh = dpmesh.make_mesh("cuda")
        mesh.all_reduce_sum([torch.zeros(1, device="cuda")])   # NCCL's set-up, untimed
        mesh.time_collectives = True
        runner = DP_WORKLOADS["halfcheetah"].make("cuda")
        runner.num_env_steps = 2 * runner.episode_length * runner.n_rollout_threads
        runner.episodes = 2
        runner.algo_args["eval"]["use_eval"] = False
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, history = runner.run(seed=0, mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        coll_ms = mesh.collective_ms()
        calls = mesh.calls
    finally:
        dpmesh.shutdown()
    launches = read_launches()
    if launches != {"gae": 2, "discounted_returns": 0}:
        raise AssertionError(f"(a) world-1 NCCL run: launches {launches}")
    by_path["dp_nccl_world1_halfcheetah"] = launches
    got = [t.detach().cpu() for t in common.replica_tensors(state, buffer=False)]
    want = ref["halfcheetah"]["steps"][-1]["tensors"]
    if len(got) != len(want) or not all(torch.equal(a, b) for a, b in zip(got, want)):
        worst = max(float((a - b).abs().max()) for a, b in zip(got, want) if a.numel())
        raise AssertionError(f"(a) world-1 NCCL run differs from the run without a mesh "
                             f"(max |Δ| {worst:.3g})")
    rate = step_env_steps(DP_WORKLOADS["halfcheetah"], ref["halfcheetah"]) / \
        step_seconds(ref["halfcheetah"])
    print(f"phase 19 (a): HalfCheetah-6x1 HAPPO {MAIN['n_envs']} x {MAIN['episode_length']} "
          f"through run(mesh=…) over a world-1 NCCL group, 2 iterations in {wall:.3f} s "
          f"(run's wall, init included); bitwise equal to the run without a mesh; {calls} "
          f"all-reduces, {coll_ms / 2:.3f} ms a iteration in them; gae launched "
          f"{launches['gae']} times; one-rank run without a mesh {rate:.1f} env-steps/s on "
          f"{card}", flush=True)

    # (b) two ranks on the one card, gloo over CUDA tensors
    t0 = time.perf_counter()
    ranks = spawn_ranks(dp_rank, 2, (card, floor, states), device="cuda:0", backend="gloo",
                        timeout_s=600)
    spawn_s = time.perf_counter() - t0
    paths, in_situ, _ = dp_check_ranks(
        card, ranks, states, ref, DP_WORKLOADS, "cuda", "phase 19 (b)",
        "2 ranks on one card (gloo; not a scaling number: both ranks share the card)")
    by_path.update({f"dp_gloo_{k}": v for k, v in paths.items()})
    log(f"phase 19 (b): {spawn_s:.1f} s with the spawn")

    # (c) the CLI: two gloo ranks on the CPU, and n_devices 1 on the card
    run = train.main(["--algo", "happo", "--env", "pettingzoo_mpe", "--platform", "cpu",
                      "--n_devices", "2", "--n_rollout_threads", "4", "--episode_length",
                      "10", "--hidden_sizes", "[8, 8]", "--num_env_steps", "80",
                      "--use_eval", "False", "--log_interval", "1", "--eval_interval", "1",
                      "--log_dir", os.path.join(log_dir, "cli_dp")])
    recs = read_run(run, 3)
    if [r["steps"] for r in recs] != [40, 80]:
        raise AssertionError(f"(c) --n_devices 2 on the CPU: records {recs}")
    print(f"phase 19 (c): train.main --platform cpu --n_devices 2 (tiny MPE HAPPO): rank 0 "
          f"logged steps {[r['steps'] for r in recs]}, value_loss "
          f"{[round(r['value_loss'], 4) for r in recs]}", flush=True)
    by_path.update(drive_tuned_paths(
        card, log_dir, [("mappo_share_param_n_devices_1", CLI_MAPPO, 2, 2, False, False)],
        {"n_devices": 1}))
    return by_path, in_situ


def small_share_param_runner(algo: str, device, noise):
    """Off-policy ``share_param`` HATD3 on continuous MPE simple_spread: the
    block sizes of ``small_off_policy_runner``, episodes of 5 steps."""
    from harl_tpu_torch.runners.off_policy import OffPolicyRunner
    from harl_tpu_torch.utils.config_tools import get_defaults_yaml_args

    algo_args, _ = get_defaults_yaml_args(algo, "pettingzoo_mpe")
    algo_args["train"].update(n_rollout_threads=16, num_env_steps=10 ** 9, warmup_steps=32,
                              train_interval=4, update_per_train=1)
    algo_args["algo"].update(batch_size=64, buffer_size=1000, share_param=True)
    algo_args["model"].update(hidden_sizes=[16, 16])
    return OffPolicyRunner({"algo": algo, "env": "pettingzoo_mpe"}, algo_args,
                           {"scenario": "simple_spread_v2", "continuous_actions": True,
                            "max_cycles": 5}, device=device, noise=noise)


def check_dp_options_against_cpu(devices=("cpu", "cuda")) -> None:
    """Phase 19 (d): the options this slice ported, on the card against the
    CPU: small HAPPO iterations with AdamW (weight decay 1e-4) and with
    ``xavier_normal_`` networks, ValueNorm's ``per_element_update`` on the
    SMACLite FP critic's shape, and an off-policy ``share_param`` HATD3
    block on MPE."""
    from harl_tpu_torch.ops import value_norm as vn

    check_family_against_cpu("happo adamw halfcheetah 2x3", "happo", "mamujoco_jax", devices,
                             model={"weight_decay": 1e-4})
    check_family_against_cpu("happo xavier_normal_ halfcheetah 2x3", "happo", "mamujoco_jax",
                             devices, model={"initialization_method": "xavier_normal_"})
    g = torch.Generator().manual_seed(8)
    xs = [torch.randn((70, 640, 1), generator=g) * 3 + 1 for _ in range(3)]
    states = []
    for dev in devices:
        st = vn.init_value_norm(1, device=dev)
        for x in xs:
            st = vn.update_value_norm(st, x.to(dev), per_element_update=True)
        states.append(st)
    for name in ("running_mean", "running_mean_sq", "debiasing_term"):
        torch.testing.assert_close(getattr(states[1], name).cpu(), getattr(states[0], name),
                                   rtol=1e-6, atol=1e-7)
    log("per_element_update ValueNorm (3 updates of 70 x 640): card == CPU (rtol 1e-6)")
    check_off_policy_against_cpu("hatd3", devices, make=small_share_param_runner,
                                 label="share_param hatd3 mpe simple_spread")


# ----------------------------------------------- the host-env path (phase 20)
class StandInCheetah:
    """A stand-in host env with HalfCheetah-6x1's spaces, in NumPy only: the
    card's machine has neither gymnasium nor mujoco, so MAMuJoCo cannot run
    there, and its rates are not MuJoCo's. Six agents of one ``Box(1)``
    action (``discrete``: ``Discrete(3)``, u = a − 1, one action of each
    agent made unavailable at random every step); an agent's obs is the 17
    state entries and a one-hot of 6, the shared obs the state. The state
    moves linearly, s' = A·s + B·u + 0.05·ε, with A and B fixed random
    matrices and ε from the env's own ``default_rng(seed)``; s[0] is a random
    walk. The reward is the forward velocity s[8] − 0.1·|u|²; an episode
    truncates at ``episode_limit`` (``bad_transition``) and terminates where
    |s[0]| leaves ``band``."""

    is_jax = False
    n_agents, dim = 6, 17
    _mats = np.random.default_rng(2024)
    A = 0.85 * np.eye(17) + 0.1 * _mats.standard_normal((17, 17)) / np.sqrt(17)
    A[0] = np.eye(17)[0]
    B = 0.1 * _mats.standard_normal((17, 6))
    B[0] = 0.01

    def __init__(self, discrete: bool = False, episode_limit: int = 150, band: float = 1.5):
        from harl_tpu_torch.utils import spaces

        self.discrete, self.episode_limit, self.band = discrete, episode_limit, band
        self.rng = np.random.default_rng(0)
        self.observation_space = [spaces.Box.create(-10.0, 10.0, self.dim + 6)] * 6
        self.share_observation_space = [spaces.Box.create(-10.0, 10.0, self.dim)] * 6
        self.action_space = [spaces.Discrete(3) if discrete
                             else spaces.Box.create(-1.0, 1.0, 1)] * 6

    def seed(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)

    def _out(self):
        obs = np.concatenate([np.tile(self.s, (6, 1)), np.eye(6)], axis=1).astype(np.float32)
        avail = None
        if self.discrete:
            avail = np.ones((6, 3), np.float32)
            avail[np.arange(6), self.rng.integers(0, 3, 6)] = 0.0
        return obs, self.s.astype(np.float32), avail

    def reset(self):
        self.t = 0
        self.s = 0.1 * self.rng.standard_normal(self.dim)
        return self._out()

    def step(self, actions):
        a = np.asarray(actions, np.float64).reshape(6, -1)[:, 0]
        u = a - 1.0 if self.discrete else np.clip(a, -1.0, 1.0)
        eps = self.rng.standard_normal(self.dim)
        self.s = self.A @ self.s + self.B @ u + 0.05 * eps
        self.s[0] += 0.03 * eps[0]
        self.t += 1
        term = bool(abs(self.s[0]) > self.band)
        trunc = self.t >= self.episode_limit
        reward = self.s[8] - 0.1 * float(u @ u)
        done = term or trunc
        infos = [{"bad_transition": trunc and not term} for _ in range(6)]
        obs, share, avail = self._out()
        return (obs, share, np.full((6, 1), reward, np.float32), np.full(6, done), infos,
                avail)


def standin_envs(n_envs: int, **kwargs):
    """``n_envs`` stand-ins in a ``HostVecEnv`` (seeds 1 + 1000·i)."""
    from harl_tpu_torch.envs.host import HostVecEnv

    return HostVecEnv([functools.partial(StandInCheetah, **kwargs)] * n_envs)


def host_configs(algo: str, shrink: dict = None) -> dict:
    """The YAML defaults of ``algo`` (happo.yaml, hatd3.yaml) without
    evaluation (the stand-in is no registered env to evaluate on), with
    ``shrink``'s keys set where the sections have them."""
    from harl_tpu_torch.utils.config_tools import get_defaults_yaml_args, update_args

    algo_args, _ = get_defaults_yaml_args(algo, "mamujoco")
    algo_args["eval"]["use_eval"] = False
    update_args(shrink or {}, algo_args)
    return algo_args


def mask_kinds(data) -> tuple:
    """(truncations, terminations) among a rollout's episode ends."""
    ended = 1.0 - data["next_masks"]
    truncated = 1.0 - data["next_bad_masks"]
    return int(truncated.sum()), int((ended - truncated).sum())


def drive_host_paths(card: str, floor: dict, device: str = "cuda", shrink: dict = None) -> tuple:
    """Phase 20 (a) and (b) on the stand-in (``StandInCheetah``). (a) HAPPO
    through ``OnPolicyRunner.run`` at happo.yaml's widths: 20 envs x 200
    steps, MLP [128, 128], the EP V critic with ValueNorm, 2 iterations;
    env-steps/s of the second, the µs a step of ``HostVecEnv.step`` against
    the rest of a collection step (the device policy and critic with their
    copies), the update's seconds; the GAE kernel once an iteration, both
    mask kinds in every iteration; then one more collection on whose
    returns inputs (T=200, b=20) the kernel is held against its plain
    version (``gae_in_situ``). (b) HATD3 through ``OffPolicyRunner.run`` at
    hatd3.yaml's widths (20 envs, warmup 10,000 steps, ``train_interval``
    50, batch 1000, buffer 1,000,000 rows, MLP [256, 256]), 2 blocks:
    env-steps/s, the buffer's GiB, every inserted row counted. Returns
    (launches by path, the in-situ GAE numbers)."""
    from harl_tpu_torch.envs.host import HostVecEnv
    from harl_tpu_torch.runners.off_policy import OffPolicyRunner
    from harl_tpu_torch.runners.on_policy import OnPolicyRunner

    by_path = {}
    algo_args = host_configs("happo", shrink)
    tr = algo_args["train"]
    B, T, iterations = tr["n_rollout_threads"], tr["episode_length"], 2
    tr["num_env_steps"] = iterations * T * B
    runner = OnPolicyRunner({"algo": "happo", "env": "standin"}, algo_args, {}, device=device,
                            env=standin_envs(B))
    zero_launches()
    t0 = time.perf_counter()
    with Spy(OnPolicyRunner, "train_iteration") as its, \
            Spy(OnPolicyRunner, "collect_host") as collects, \
            Spy(OnPolicyRunner, "update_phase", keep=lambda out: None) as updates, \
            Spy(HostVecEnv, "step", sync=False, keep=lambda out: None) as env_steps:
        state, history = runner.run(seed=1)
    wall = time.perf_counter() - t0
    launches = read_launches()
    if launches != {"gae": iterations, "discounted_returns": 0} or len(its.calls) != iterations:
        raise AssertionError(f"host happo: launches {launches}, {len(its.calls)} iterations")
    for i, (_, _, args, _) in enumerate(updates.calls):
        kinds = mask_kinds(args[1])
        if min(kinds) < 1:
            raise AssertionError(f"host happo iteration {i + 1}: (truncations, terminations) "
                                 f"{kinds}; both kinds are required")
    if not all(math.isfinite(r["value_loss"]) for r in history):
        raise AssertionError(f"host happo: records {history}")
    env_us = sum(c[0] for c in env_steps.calls[T:2 * T]) / T * 1e6
    collect_us = collects.calls[1][0] / T * 1e6
    print(f"host_happo: stand-in HalfCheetah-6x1 (NumPy, not MuJoCo) on HostVecEnv, {B} envs "
          f"x {T} steps, MLP {list(runner.hidden_sizes)}, through OnPolicyRunner.run in "
          f"{wall:.2f} s; iterations of {', '.join(f'{c[0]:.4f}' for c in its.calls)} s, "
          f"{T * B / its.calls[1][0]:.1f} env-steps/s in the second; a collection step "
          f"{collect_us:.1f} us: HostVecEnv.step {env_us:.1f} us, the device policy and critic "
          f"with their copies {collect_us - env_us:.1f} us; update "
          f"{', '.join(f'{c[0]:.4f}' for c in updates.calls)} s; (truncations, terminations) "
          f"by iteration {[mask_kinds(c[2][1]) for c in updates.calls]}; launches {launches} "
          f"on {card}", flush=True)
    by_path["host_happo"] = launches
    in_situ = gae_in_situ("host_happo", runner, state, (T, B, 1), floor, card)

    algo_args = host_configs("hatd3", shrink)
    tr, blocks = algo_args["train"], 2
    B, interval = tr["n_rollout_threads"], tr["train_interval"]
    tr["num_env_steps"] = blocks * interval * B
    runner = OffPolicyRunner({"algo": "hatd3", "env": "standin"}, algo_args, {}, device=device,
                             env=standin_envs(B))
    zero_launches()
    t0 = time.perf_counter()
    with Spy(OffPolicyRunner, "warmup_block", keep=lambda out: None) as warm, \
            Spy(OffPolicyRunner, "collect_block") as collects, \
            Spy(OffPolicyRunner, "train_block") as trains:
        state, history = runner.run(seed=1)
    wall = time.perf_counter() - t0
    launches = read_launches()
    buf = state.buffer
    inserted = (tr["warmup_steps"] // B + blocks * interval) * B
    if launches != {"gae": 0, "discounted_returns": 0} or len(trains.calls) != blocks:
        raise AssertionError(f"host hatd3: launches {launches}, {len(trains.calls)} blocks")
    if buf.cur_size != min(inserted, buf.buffer_size):
        raise AssertionError(f"host hatd3: {buf.cur_size} rows in the buffer, {inserted} "
                             "inserted")
    rows = buf.cur_size
    if not (torch.isfinite(buf.obs[0][:rows]).all() and torch.isfinite(buf.rewards[:rows]).all()
            and math.isfinite(history[-1]["critic_loss"])):
        raise AssertionError("host hatd3: non-finite rows or losses")
    nbytes = sum(x.numel() * x.element_size() for v in vars(buf).values()
                 for x in (v if isinstance(v, list) else [v]) if isinstance(x, torch.Tensor))
    times = [c[0] + t[0] for c, t in zip(collects.calls, trains.calls)]
    episodes = int(sum(float(c[3][1]["episode_count"]) for c in collects.calls))
    print(f"host_hatd3: stand-in HalfCheetah-6x1 on HostVecEnv, {B} envs, warmup "
          f"{tr['warmup_steps']} steps ({warm.calls[0][0]:.4f} s), blocks of {interval} steps, "
          f"batch {runner.batch_size}, MLP {list(runner.actors[0].hidden_sizes)}, through "
          f"OffPolicyRunner.run in {wall:.2f} s; blocks of "
          f"{', '.join(f'{t:.4f}' for t in times)} s (collect "
          f"{', '.join(f'{c[0]:.4f}' for c in collects.calls)} s), "
          f"{blocks * interval * B / sum(times):.1f} env-steps/s over both; {rows} rows read "
          f"back of {inserted} inserted, replay buffer of {buf.buffer_size} rows "
          f"{nbytes / 2 ** 30:.3f} GiB on the card; {episodes} episodes ended in the blocks; "
          f"launches {launches} on {card}", flush=True)
    by_path["host_hatd3"] = launches
    return by_path, in_situ


def check_host_against_cpu(devices=("cpu", "cuda")) -> None:
    """Phase 20 (c): a small HAPPO iteration with GRU actors and critic on
    the Discrete stand-in (8 envs x 40 steps, episodes truncated at 15 steps
    or ended past |s[0]| > 0.3), and a small HATD3 warmup, block and train on
    the Box one, on the card and on the CPU from the same seeds: actions,
    availability, masks and bad masks equal, floats at rtol 1e-3, atol
    1e-4."""
    from harl_tpu_torch.runners.off_policy import OffPolicyRunner
    from harl_tpu_torch.runners.on_policy import OnPolicyRunner
    from harl_tpu_torch.utils.noise import GeneratorNoise

    small = dict(episode_limit=15, band=0.3)
    runs = []
    for dev in devices:
        algo_args = host_configs("happo", {"n_rollout_threads": 8, "episode_length": 40,
                                           "hidden_sizes": [16, 16], "ppo_epoch": 2,
                                           "critic_epoch": 2, "use_recurrent_policy": True,
                                           "data_chunk_length": 10})
        noise = GeneratorNoise(torch.Generator().manual_seed(8), dev)
        runner = OnPolicyRunner({"algo": "happo", "env": "standin"}, algo_args, {}, device=dev,
                                noise=noise, env=standin_envs(8, discrete=True, **small))
        state = runner.init_state(0)
        if runs:   # the card's runner starts from the CPU runner's parameters
            cpu_state = runs[0][0]
            for a, b in zip(state.actors + [state.critic], cpu_state.actors + [cpu_state.critic]):
                a.net.load_state_dict(b.net.state_dict())
        runs.append((state, runner))
    outs = []
    for state, runner in runs:
        with Spy(OnPolicyRunner, "update_phase", sync=False) as updates:
            outs.append((*runner.train_iteration(state), updates.calls[0][2][1]))
    torch.cuda.synchronize()
    (s_cpu, m_cpu, d_cpu), (s_gpu, m_gpu, d_gpu) = outs
    close = lambda a, b: torch.testing.assert_close(
        torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu(), rtol=E2E_RTOL, atol=E2E_ATOL)
    for k in ("avail", "masks", "active_masks", "next_masks", "next_bad_masks", "emitted_cnt"):
        if not torch.equal(d_gpu[k].cpu(), d_cpu[k]):
            raise AssertionError(f"host happo GRU: {k} differ on the card")
    for a, b in zip(d_gpu["actions"], d_cpu["actions"]):
        if not torch.equal(a.cpu(), b):
            raise AssertionError("host happo GRU: actions differ on the card")
    for k in ("obs", "value", "reward", "emitted_ret", "critic_rnn"):
        close(d_gpu[k], d_cpu[k])
    kinds = mask_kinds(d_cpu)
    if min(kinds) < 1:
        raise AssertionError(f"host happo GRU: (truncations, terminations) {kinds}")
    for k in ("value_loss", "critic_grad_norm", "mean_step_reward", "episode_return_sum"):
        close(m_gpu[k], m_cpu[k])
    close(m_gpu["actor_stats"], m_cpu["actor_stats"])
    for a, b in zip(s_gpu.actors + [s_gpu.critic], s_cpu.actors + [s_cpu.critic]):
        for va, vb in zip(a.net.state_dict().values(), b.net.state_dict().values()):
            close(va, vb)
    log(f"small host HAPPO GRU iteration on the Discrete stand-in: card == CPU (actions, "
        f"availability, masks and bad masks equal; (truncations, terminations) {kinds}; floats "
        f"at rtol {E2E_RTOL}, atol {E2E_ATOL})")

    def make(algo, dev, noise):
        algo_args = host_configs(algo, {"n_rollout_threads": 16, "warmup_steps": 32,
                                        "train_interval": 4, "batch_size": 64,
                                        "buffer_size": 1000, "hidden_sizes": [16, 16]})
        return OffPolicyRunner({"algo": algo, "env": "standin"}, algo_args, {}, device=dev,
                               noise=noise, env=standin_envs(16, episode_limit=5, band=0.3))

    check_off_policy_against_cpu("hatd3", devices, make, label="host hatd3 stand-in")


# ------------------------------------------------- learning parity (phase 21)
PARITY_RUN = "football_pass_and_shoot_with_keeper"
PARITY_ITERATIONS = 2


def load_parity_script():
    """``scripts/torch_learning_parity.py`` as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "torch_learning_parity.py")
    spec = importlib.util.spec_from_file_location("torch_learning_parity", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def drive_parity_path(card: str, log_dir: str, platform: str = "cuda",
                      extra: tuple = ()) -> tuple:
    """Phase 21: ``scripts/torch_learning_parity.py`` on one of its runs,
    tuned academy pass_and_shoot_with_keeper HAPPO at its widths (256 envs
    x 200 steps, GRU, 15 epochs of 2 minibatches), seed 1, cut to 2
    iterations and the evaluation at the last one (the config's 100
    episodes on 50 envs). The GAE kernel launched once an iteration, its
    error on the run's own inputs (T=200, b=256) within 1e-5 of the
    largest return, the curves and the record written. Returns (launches,
    the in-situ GAE numbers)."""
    parity = load_parity_script()
    out = os.path.join(log_dir, "curves")
    zero_launches()
    t0 = time.perf_counter()
    rec = parity.run_one(PARITY_RUN, 1, platform, out, os.path.join(log_dir, "runs"),
                         PARITY_ITERATIONS, extra)
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = PARITY_ITERATIONS if platform == "cuda" else 0
    if (launches["gae"], rec["gae_launches"], launches["discounted_returns"]) != (want, want, 0):
        raise AssertionError(f"parity {PARITY_RUN}: launches {launches}, the record's "
                             f"{rec['gae_launches']} (gae once an iteration)")
    situ = rec["gae_in_situ"]
    if situ["max_abs_err"] > parity.GAE_REL_BOUND * situ["max_abs_return"]:
        raise AssertionError(f"parity {PARITY_RUN}: in-situ gae error {situ}")
    steps = rec["env_steps"]
    with open(os.path.join(out, f"{PARITY_RUN}_s1_won.csv")) as f:
        won = [line.strip().split(",") for line in f]
    if len(rec["eval_s"]) != 1 or [int(s) for s, _ in won] != [steps] or \
            not 0.0 <= float(won[0][1]) <= 1.0:
        raise AssertionError(f"parity {PARITY_RUN}: evals {rec['eval_s']}, won curve {won}")
    print(f"parity {PARITY_RUN}: scripts/torch_learning_parity.py, {rec['iterations']} "
          f"iterations of {', '.join(f'{t:.4f}' for t in rec['iteration_s'])} s and an eval "
          f"of {rec['eval_s'][0]:.2f} s (score rate {float(won[0][1]):.3f}), "
          f"{rec['env_steps_per_s']:.1f} env-steps/s over the run, {wall:.2f} s in all; gae "
          f"launched {launches['gae']} times, in situ (T={situ['T']}, b={situ['b']}) max "
          f"|err| {situ['max_abs_err']:.3g} of returns up to {situ['max_abs_return']:.3g}, "
          f"{situ['ms'] if situ['ms'] is None else round(situ['ms'] * 1e3, 3)} us warm, bound "
          f"{situ['bound_ms'] * 1e3:.3f} us; peak {rec['peak_cuda_bytes']} bytes on the "
          f"device on {card}", flush=True)
    return {"parity_" + PARITY_RUN: launches}, situ


# ------------------------------------------- several cards (phase 22)
def drive_multicard_paths(card: str, floor: dict, log_dir: str) -> tuple:
    """Phase 22: ``scripts/torch_multicard.py``'s legs on this one card
    (its ``smoke_phase``): legs 1, 3 and 4 on one rank over a world-1 NCCL
    group, legs 1 and 2 on 4 gloo ranks sharing the card. Returns (launches
    by path, the GAE kernel's in-situ numbers by path)."""
    import importlib

    repo = os.path.dirname(os.path.abspath(__file__))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    t0 = time.perf_counter()
    multicard = importlib.import_module("scripts.torch_multicard")
    by_path, in_situ = multicard.smoke_phase(card, floor, log_dir)
    log(f"phase 22: {time.perf_counter() - t0:.1f} s")
    return by_path, in_situ


# ------------------------------------------- the largest replay ring (phase 23)
REPLAY_MAP = "8m_vs_9m"
REPLAY_WARMUP = 1000
GIB = 2 ** 30
# a restore may allocate this much beyond the live ring and networks
RESTORE_HEADROOM = 4 * GIB
# the ring is held against the file in chunks of at most this many bytes
CHUNK_BYTES = GIB


def equal_in_chunks(live, saved, chunk_bytes: int = CHUNK_BYTES) -> bool:
    """``live`` (on its device) and ``saved`` (a CPU tensor, memory-mapped)
    hold the same bytes, compared ``chunk_bytes`` at a time on ``live``'s
    device (each chunk brought there by ``checkpoint.copy_to_device``)."""
    from harl_tpu_torch.utils.checkpoint import copy_to_device

    a = live.reshape(-1).view(torch.uint8)
    b = saved.reshape(-1).view(torch.uint8)
    if a.numel() != b.numel():
        return False
    chunk = torch.empty(min(chunk_bytes, a.numel()), dtype=torch.uint8, device=a.device)
    for lo in range(0, a.numel(), chunk_bytes):
        n = min(chunk_bytes, a.numel() - lo)
        copy_to_device(chunk[:n], b[lo:lo + n])
        if not torch.equal(a[lo:lo + n], chunk[:n]):
            return False
    return True


def measured_restore(restore, runner, state, model_dir: str, fill_card: bool = False) -> tuple:
    """(the state, the restore's record) of ``restore(state, model_dir)``
    (``OffPolicyRunner.restore`` or a wrapper of it): its seconds, the
    peak device memory during it with the peak reset just before, the
    card's free memory as it starts, the ring's bytes, whether every ring
    tensor kept its storage, and whether each column equals the checkpoint
    file's bytes (``equal_in_chunks``). With ``fill_card``, a ballast holds
    all of the card's free memory but ``RESTORE_HEADROOM`` during the
    restore, so that no second ring could land beside the live one; the
    record's ``ballast_bytes`` counts it."""
    from harl_tpu_torch.buffers.off_policy import ring_columns
    from harl_tpu_torch.utils import checkpoint

    device = runner.device
    cuda = device.type == "cuda"
    ptrs = [t.data_ptr() for t in state.buffer.tensors()]
    ballast = None
    sync(device)
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
        if fill_card:
            spare = torch.cuda.mem_get_info(device)[0] - RESTORE_HEADROOM
            ballast = torch.empty(max(spare, 0), dtype=torch.uint8, device=device)
        torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device) if cuda else None
    card_free = torch.cuda.mem_get_info(device)[0] if cuda else None
    t0 = time.perf_counter()
    state = restore(state, model_dir)
    sync(device)
    restore_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    ballast_bytes = 0 if ballast is None else ballast.nbytes
    del ballast
    ring = state.buffer.tensors()
    path = checkpoint.latest_checkpoint(model_dir) or model_dir
    t0 = time.perf_counter()
    saved = checkpoint.restore_state(path)["state"]["buffer"]
    columns = ring_columns(saved.get)
    equal = len(columns) == len(ring) and all(equal_in_chunks(a, b)
                                              for a, b in zip(ring, columns))
    del saved, columns
    rec = dict(path=path, restore_s=restore_s, ring_bytes=state.buffer.nbytes,
               allocated_before_bytes=before, card_free_bytes=card_free,
               ballast_bytes=ballast_bytes, peak_bytes=peak,
               peak_over_before_bytes=None if peak is None else peak - before,
               storage_kept=[t.data_ptr() for t in ring] == ptrs, ring_equals_file=equal,
               compare_s=time.perf_counter() - t0, ring_rows=state.buffer.cur_size)
    return state, rec


def check_restore(rec: dict, what: str) -> None:
    """Raise unless the restore kept the ring's storage, stayed below the
    ring plus ``RESTORE_HEADROOM`` on the card (its ballast aside) and
    restored the file's bytes."""
    if not rec["storage_kept"]:
        raise AssertionError(f"{what}: a ring tensor changed storage in the restore")
    if not rec["ring_equals_file"]:
        raise AssertionError(f"{what}: the restored ring differs from the checkpoint's bytes")
    if rec["peak_bytes"] is not None and \
            rec["peak_bytes"] - rec["ballast_bytes"] >= rec["ring_bytes"] + RESTORE_HEADROOM:
        raise AssertionError(f"{what}: {rec['peak_bytes'] - rec['ballast_bytes']} bytes on "
                             f"the card during the restore (its ballast of "
                             f"{rec['ballast_bytes']} aside), the ring {rec['ring_bytes']} "
                             f"+ {RESTORE_HEADROOM}")


def host_available_bytes() -> int:
    """The host memory the kernel counts as available (``MemAvailable``)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/meminfo has no MemAvailable line")


def copy_rates(path: str, device) -> tuple:
    """GiB/s of two host-to-card copies of ``CHUNK_BYTES`` of the largest
    ring column of the checkpoint at ``path``, each from a mapping of its
    own: straight from the mapped, pageable file (``copy_``), and through
    ``checkpoint.copy_to_device``'s pinned stages."""
    from harl_tpu_torch.buffers.off_policy import ring_columns
    from harl_tpu_torch.utils import checkpoint

    rates = []
    dst = torch.empty(CHUNK_BYTES, dtype=torch.uint8, device=device)
    for copy in (lambda d, s: d.copy_(s), checkpoint.copy_to_device):
        saved = max(ring_columns(checkpoint.restore_state(path)["state"]["buffer"].get),
                    key=lambda t: t.nbytes)
        src = saved.reshape(-1).view(torch.uint8)[:CHUNK_BYTES]
        sync(device)
        t0 = time.perf_counter()
        copy(dst[:src.numel()], src)
        sync(device)
        rates.append(src.numel() / GIB / (time.perf_counter() - t0))
        del saved, src
    return tuple(rates)


def drive_replay_scale_path(card: str, log_dir: str, device: str = "cuda",
                            shrink: tuple = ()) -> dict:
    """Phase 23: the tuned ``REPLAY_MAP`` FP HASAC runner with its full ring (``shrink``,
    words of argv, narrows it for a rehearsal on the CPU), a warmup of
    ``REPLAY_WARMUP`` env-steps and one block, a checkpoint, one more
    collect block, and the checkpoint restored in place by the runner's
    ``restore`` with ``measured_restore`` (the card filled but for
    ``RESTORE_HEADROOM``, less than a ring), held by ``check_restore``.
    The checkpoint is a memory file (``memfd``), reached through a
    ``ckpt_<rows>/state.pt`` link under ``log_dir`` and gone when it is
    closed or the process ends: the host writes nothing of the ring to
    disk, whose writes the H100 hosts this phase runs on cap at 45 GiB a
    run. Returns the launches (none: the path is off-policy)."""
    from harl_tpu_torch import train
    from harl_tpu_torch.buffers.off_policy import require_room
    from harl_tpu_torch.runners.off_policy import OffPolicyRunner
    from harl_tpu_torch.utils import checkpoint

    args, algo_args, env_args = train.resolve_args(
        ["--load_config", f"tuned_configs/smaclite/{REPLAY_MAP}/hasac/config.json",
         "--warmup_steps", str(REPLAY_WARMUP), *shrink])
    t_all = time.perf_counter()
    runner = OffPolicyRunner(args, algo_args, env_args, device=device)
    need = runner.ring_nbytes()
    cuda = runner.device.type == "cuda"
    if cuda:
        # the earlier phases' cached blocks go back to the card first
        gc.collect()
        torch.cuda.empty_cache()
        require_room(need, torch.cuda.mem_get_info(runner.device)[0],
                     "the card's free memory for the replay ring")
    zero_launches()
    t0 = time.perf_counter()
    state = runner.init_state(1)
    sync(runner.device)
    init_s = time.perf_counter() - t0
    if state.buffer.nbytes != need:
        raise AssertionError(f"phase 23: the ring holds {state.buffer.nbytes} bytes, "
                             f"{need} predicted")
    t0 = time.perf_counter()
    state = runner.warmup_block(state)
    state, _ = runner.collect_block(state)
    state, metrics = runner.train_block(state)
    sync(runner.device)
    block_s = time.perf_counter() - t0
    if not math.isfinite(float(metrics["critic_loss"])):
        raise AssertionError(f"phase 23: critic loss {metrics['critic_loss']}")
    launches = read_launches()
    rows = state.buffer.cur_size
    require_room(need, host_available_bytes(),
                 "the host's available memory for the replay ring's checkpoint")
    fd = os.memfd_create("chip_smoke_ring")
    try:
        file = f"/proc/self/fd/{fd}"
        t0 = time.perf_counter()
        torch.save(runner.checkpoint(state), file)
        write_s = time.perf_counter() - t0
        file_bytes = os.fstat(fd).st_size
        path = os.path.join(log_dir, f"ckpt_{rows}")
        os.makedirs(path)
        os.symlink(file, os.path.join(path, checkpoint.STATE_FILE))
        # the ring moves on past the checkpoint, so the restore has rows to undo
        state, _ = runner.collect_block(state)
        if state.buffer.cur_size == rows:
            raise AssertionError("phase 23: the collect block inserted no row")
        state, rec = measured_restore(runner.restore, runner, state, log_dir, fill_card=True)
        check_restore(rec, "phase 23")
        if state.buffer.cur_size != rows:
            raise AssertionError(f"phase 23: {state.buffer.cur_size} rows restored, "
                                 f"{rows} saved")
        if cuda and rec["card_free_bytes"] >= need:
            raise AssertionError(f"phase 23: {rec['card_free_bytes']} bytes free on the card "
                                 f"during the restore, room for a second ring of {need}")
        rates = copy_rates(path, runner.device) if cuda else (None, None)
    finally:
        shutil.rmtree(os.path.join(log_dir, f"ckpt_{rows}"), ignore_errors=True)
        gc.collect()
        os.close(fd)
    peak_reserved = torch.cuda.max_memory_reserved(runner.device) if cuda else None
    print(f"replay_scale {REPLAY_MAP} FP HASAC (its tuned config, warmup cut to "
          f"{runner.warmup_steps}): ring {need / GIB:.4f} GiB predicted, "
          f"{state.buffer.nbytes / GIB:.4f} allocated in {init_s:.2f} s; warmup and one "
          f"block {block_s:.2f} s; checkpoint {file_bytes} bytes written to a memory file in "
          f"{write_s:.2f} s; restored in place in {rec['restore_s']:.2f} s, "
          f"{rec['card_free_bytes']} bytes free on the card as it started (a ballast of "
          f"{rec['ballast_bytes']}), a peak of {rec['peak_bytes']} bytes on the card "
          f"({rec['peak_over_before_bytes']} over the {rec['allocated_before_bytes']} before "
          f"it, bound ring + {RESTORE_HEADROOM} beside the ballast; peak reserved "
          f"{peak_reserved}), storage kept, ring equal to the file's bytes in 1 GiB chunks "
          f"({rec['compare_s']:.2f} s); host to card from the mapped file, 1 GiB: pageable "
          f"{rates[0]} GiB/s, pinned stages {rates[1]} GiB/s; "
          f"{time.perf_counter() - t_all:.1f} s in all on {card}", flush=True)
    return {"replay_scale_" + REPLAY_MAP: launches}


# ---------------- tuned HASAC HalfCheetah-6x1 at a late state, card against CPU (phase 24)
LATE_HASAC = dict(rows=410_000, adam_count=20_000, log_alpha=-6.0, warmup_steps=4_000)
# One env step, or one update, from the same state on both devices (TF32
# off): float32 reduced in another order by the card's and the CPU's
# kernels. The rows a step inserts, its metrics and the critic loss at the
# off-policy witness's data tolerance; parameters, targets, Adam moments and
# log α after one Adam step at its parameter tolerance (a step moves a
# parameter by ~lr times a gradient's relative error; lr 1e-3).
LATE_DATA_RTOL, LATE_DATA_ATOL = 1e-4, 2e-4
LATE_PARAM_RTOL, LATE_PARAM_ATOL = 1e-4, 1e-5


class RecordedNoise:
    """A noise source that draws from ``base`` and keeps a CPU copy of each
    draw in order: (kind, its first argument, the draw)."""

    def __init__(self, base):
        self.base, self.log = base, []

    def __getattr__(self, kind):
        fn = getattr(self.base, kind)

        def draw(*args):
            out = fn(*args)
            cpu = (tuple(x.cpu() for x in out) if isinstance(out, tuple) else out.cpu())
            self.log.append((kind, args[0] if args else None, cpu))
            return out
        return draw


class QueuedNoise:
    """Hands out the draws a ``RecordedNoise`` kept, in order and on
    ``device``, raising where a draw of another kind or shape is asked."""

    def __init__(self, log, device):
        self.log, self.device = list(log), torch.device(device)

    def __getattr__(self, kind):
        def draw(*args):
            if not self.log:
                raise AssertionError(f"{kind}{args}: no recorded draw left")
            k, first, out = self.log.pop(0)
            if k != kind or first != (args[0] if args else None):
                raise AssertionError(f"asked {kind}{args}, recorded {k}({first}, ...)")
            if kind == "permutation":
                return out
            return (tuple(x.to(self.device) for x in out) if isinstance(out, tuple)
                    else out.to(self.device))
        return draw


def set_truncations(state, episode_limit: int, within: int) -> None:
    """Each env's step counter set near ``episode_limit``, so that env ``e``
    of ``B`` is truncated at its ``1 + e·(within − 1)//(B − 1)``-th step
    from here."""
    if not 0 < within < episode_limit:
        raise ValueError(f"truncations within {within} steps of a {episode_limit}-step limit")
    t = state.carry.env_state.t
    left = 1 + torch.arange(t.shape[0], device=t.device) * (within - 1) // max(t.shape[0] - 1, 1)
    t.copy_((episode_limit - left).to(t.dtype))


def set_late(state, rows: int, count: int, log_alpha: float) -> int:
    """What a long run reaches, set in place: the ring's first ``rows`` rows
    its rows so far repeated whole in insertion order (each env's stride and
    its done and term flags as inserted), the cursor at the head; every Adam
    count (networks' and α's) at ``count``; every log α at ``log_alpha``.
    Returns the rows repeated."""
    buf = state.buffer
    period = buf.cur_size
    if not 0 < period <= rows <= buf.buffer_size:
        raise ValueError(f"a ring of {rows} rows from {period} in {buf.buffer_size}")
    src = torch.arange(rows, device=buf.dones.device) % period
    for col in buf.tensors():
        col[:rows] = col[src]
    buf.idx, buf.cur_size = rows % buf.buffer_size, rows
    opts = [st.opt for st in state.actors] + [state.critic.opt]
    opts += [o.alpha_opt for o in state.actors + [state.critic] if o.alpha_opt is not None]
    for opt in opts:
        for st in opt.state.values():
            st["step"].fill_(float(count))
    with torch.no_grad():
        for o in state.actors + [state.critic]:
            if o.log_alpha is not None:
                o.log_alpha.fill_(log_alpha)
    return period


def copy_learners(src, dst) -> None:
    """The networks, targets, optimizers and α of ``src`` into ``dst``
    (another device's state of the same runner config), and its count."""
    from harl_tpu_torch.utils import checkpoint

    for a, b in zip(src.actors, dst.actors):
        checkpoint.load_payload(b, checkpoint.to_payload(a))
    checkpoint.load_payload(dst.critic, checkpoint.to_payload(src.critic))
    dst.total_it = src.total_it


class LateHold:
    """The largest error of each quantity over the phase, over its
    tolerance, with where it was."""

    def __init__(self):
        self.q = {}

    def hold(self, name, got, ref, rtol, atol, where):
        g, r = got.detach().double().cpu(), ref.detach().double().cpu()
        if g.shape != r.shape:
            raise AssertionError(f"{name} {where}: {tuple(g.shape)} against {tuple(r.shape)}")
        err = (g - r).abs()
        excess = err / (atol + rtol * r.abs())
        excess = torch.where(torch.isfinite(excess), excess, torch.full_like(excess, math.inf))
        worst = float(excess.max()) if excess.numel() else 0.0
        rec = self.q.setdefault(name, dict(max_abs_err=0.0, max_excess=0.0, where=None,
                                           rtol=rtol, atol=atol))
        rec["max_abs_err"] = max(rec["max_abs_err"], float(err.max()) if err.numel() else 0.0)
        if worst > rec["max_excess"] or rec["where"] is None:
            rec["max_excess"], rec["where"] = max(worst, rec["max_excess"]), where

    def check(self) -> None:
        bad = {k: v for k, v in self.q.items() if not v["max_excess"] <= 1.0}
        if bad:
            raise AssertionError(f"tuned HASAC, card against CPU: {bad}")


def hold_late_learners(h: LateHold, a, b, unit: str) -> None:
    """Every parameter, target, Adam moment and log α of state ``a`` (the
    CPU's) against ``b`` (the card's)."""
    pairs = [(f"actor {i}", "actor", x, y) for i, (x, y) in enumerate(zip(a.actors, b.actors))]
    pairs.append(("critic", "critic", a.critic, b.critic))
    tol = (LATE_PARAM_RTOL, LATE_PARAM_ATOL)
    for who, kind, x, y in pairs:
        xn, yn = (x.net, y.net) if kind == "actor" else (x.nets, y.nets)
        xt, yt = (x.target, y.target) if kind == "actor" else (x.targets, y.targets)
        for (k, p), q in zip(xn.named_parameters(), yn.parameters()):
            h.hold(f"{kind}.params", p, q, *tol, f"{unit} {who} {k}")
            for m in ("exp_avg", "exp_avg_sq"):
                h.hold(f"{kind}.{m}", x.opt.state[p][m], y.opt.state[q][m], *tol,
                       f"{unit} {who} {k}")
            if float(x.opt.state[p]["step"]) != float(y.opt.state[q]["step"]):
                raise AssertionError(f"{unit} {who} {k}: Adam counts differ")
        for (k, p), q in zip(xt.state_dict().items(), yt.state_dict().values()):
            h.hold(f"{kind}.targets", p, q, *tol, f"{unit} {who} {k}")
        if x.log_alpha is not None:
            h.hold(f"{kind}.log_alpha", x.log_alpha, y.log_alpha, *tol, f"{unit} {who}")


def drive_late_hasac_path(card: str, device: str = "cuda", shrink: tuple = (),
                          n_units: int = 50) -> dict:
    """Phase 24: tuned HASAC HalfCheetah-6x1 (``CLI_HASAC``: 20 envs,
    [256, 256] with feature normalisation, batch 1000, ``n_step`` 10,
    auto-α, a 1,000,000-row ring) at a late state (``LATE_HASAC``: a ring of
    410,000 rows made of a 4,000-row warmup repeated whole, each env's step
    counter set first so that it is truncated in the warmup's first half;
    every Adam count 20,000, every log α −6; each env's step counter set
    again so that it is truncated, and reset, once within the first four
    fifths of the held steps), on ``device``, held against a CPU runner of
    the same config one unit at a time: ``n_units`` collect steps, the
    CPU's carry and cursor set to the card's before each and the rows it
    inserts then copied from the card's, and a train block of ``n_units``
    updates, the CPU's networks,
    optimizers and α set to the card's before each; every draw the card's,
    copied to the CPU (``RecordedNoise``, ``QueuedNoise``). Held at
    ``LATE_DATA_*`` and ``LATE_PARAM_*`` (``LateHold``), and every env
    must end one episode; ``shrink`` (words of argv) narrows it and
    ``n_units`` shortens it for a rehearsal. Returns the launches (none:
    the path is off-policy)."""
    from harl_tpu_torch import train
    from harl_tpu_torch.runners.off_policy import OffPolicyRunner
    from harl_tpu_torch.utils import checkpoint
    from harl_tpu_torch.utils.noise import GeneratorNoise

    t_all = time.perf_counter()
    zero_launches()
    late = dict(LATE_HASAC)
    args, algo_args, env_args = train.resolve_args(
        ["--load_config", CLI_HASAC, "--warmup_steps", str(late["warmup_steps"]),
         "--train_interval", "1", "--update_per_train", "1", *shrink])
    if shrink:
        late["rows"] = algo_args["algo"]["buffer_size"] * 41 // 100
    gen = torch.Generator(device=device).manual_seed(24)
    rec = RecordedNoise(GeneratorNoise(gen, device, torch.Generator().manual_seed(24)))
    runner = OffPolicyRunner(args, copy.deepcopy(algo_args), copy.deepcopy(env_args),
                             device=device, noise=rec)
    limit = runner.env.episode_limit
    state = runner.init_state(1)
    set_truncations(state, limit, runner.warmup_steps // runner.n_envs // 2)
    t0 = time.perf_counter()
    state = runner.warmup_block(state)
    state, _ = runner.train_block(state)           # Adam's moments exist
    sync(device)
    warmup_s = time.perf_counter() - t0
    if not bool(state.buffer.dones[:state.buffer.cur_size].any()):
        raise AssertionError("tuned HASAC late state: the warmup crossed no truncation")
    period = set_late(state, late["rows"], late["adam_count"], late["log_alpha"])
    set_truncations(state, limit, n_units * 4 // 5)
    rec.log.clear()
    queue = QueuedNoise([], "cpu")
    cpu = OffPolicyRunner(args, copy.deepcopy(algo_args), copy.deepcopy(env_args),
                          device="cpu", noise=queue)
    gen_cpu = torch.Generator().manual_seed(0)
    cstate = cpu.new_state(gen_cpu, *cpu.vec.reset(GeneratorNoise(gen_cpu, "cpu")))
    t0 = time.perf_counter()
    checkpoint.load_payload(cstate, checkpoint.to_payload(state))
    sync(device)
    copy_s = time.perf_counter() - t0
    h, B, S = LateHold(), runner.n_envs, state.buffer.buffer_size
    dtol, ended = (LATE_DATA_RTOL, LATE_DATA_ATOL), 0.0
    t0 = time.perf_counter()
    for step in range(n_units):
        unit = f"collect step {step + 1}"
        cstate.carry = type(state.carry)(*[None if x is None else _to_cpu(x)
                                           for x in state.carry])
        cstate.buffer.idx, cstate.buffer.cur_size = state.buffer.idx, state.buffer.cur_size
        idx = state.buffer.idx
        state, cm = runner.collect_block(state)
        queue.log = rec.log
        rec.log = []
        cstate, ccm = cpu.collect_block(cstate)
        if queue.log:
            raise AssertionError(f"{unit}: {len(queue.log)} draws left")
        rows = (idx + torch.arange(B)) % S
        for k in ("share_obs", "next_share_obs", "rewards", "dones", "terms"):
            h.hold(f"insert.{k}", getattr(cstate.buffer, k)[rows],
                   getattr(state.buffer, k)[rows.to(device)], *dtol, unit)
        for k in ("obs", "next_obs", "actions", "valid_transitions"):
            for i, (x, y) in enumerate(zip(getattr(cstate.buffer, k),
                                           getattr(state.buffer, k))):
                h.hold(f"insert.{k}", x[rows], y[rows.to(device)], *dtol, f"{unit} agent {i}")
        for k in ("episode_return_sum", "episode_count", "mean_step_reward"):
            h.hold(f"collect.{k}", ccm[k], cm[k], *dtol, unit)
        for k in ("obs", "share_obs", "ep_ret"):
            h.hold(f"carry.{k}", getattr(cstate.carry, k), getattr(state.carry, k), *dtol, unit)
        for k in ("q", "qd"):
            h.hold(f"carry.env_{k}", getattr(cstate.carry.env_state, k),
                   getattr(state.carry.env_state, k), *dtol, unit)
        ended += float(cm["episode_count"])
        for x, y in zip(cstate.buffer.tensors(), state.buffer.tensors()):
            x[rows] = y[rows.to(device)].cpu()          # the rings stay equal
    collect_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    losses = []
    for u in range(n_units):
        unit = f"update {u + 1}"
        copy_learners(state, cstate)
        state, tm = runner.train_block(state)
        queue.log = rec.log
        rec.log = []
        cstate, ctm = cpu.train_block(cstate)
        if queue.log:
            raise AssertionError(f"{unit}: {len(queue.log)} draws left")
        h.hold("update.critic_loss", ctm["critic_loss"], tm["critic_loss"], *dtol, unit)
        hold_late_learners(h, cstate, state, unit)
        losses.append(float(tm["critic_loss"]))
    train_s = time.perf_counter() - t0
    h.check()
    if ended != B:
        raise AssertionError(f"tuned HASAC late state: {ended:.0f} episodes ended in "
                             f"{n_units} collect steps of {B} envs, each set to end once")
    if not all(math.isfinite(x) for x in losses) or state.total_it != 1 + n_units:
        raise AssertionError(f"tuned HASAC late state: losses {losses}, {state.total_it} updates")
    alphas = [round(float(torch.exp(st.log_alpha.detach())), 8) for st in state.actors]
    worst = {k: (f"{v['max_excess']:.3g}", f"{v['max_abs_err']:.3g}") for k, v in h.q.items()}
    print(f"late tuned HASAC HalfCheetah-6x1 ({B} envs, "
          f"{algo_args['model']['hidden_sizes']}, batch {runner.batch_size}, n_step "
          f"{runner.n_step}): a ring of {late['rows']} "
          f"rows ({period} rows of warmup repeated whole), Adam counts "
          f"{late['adam_count']}, log alpha {late['log_alpha']}; {n_units} collect steps "
          f"({ended:.0f} episodes ended) and {n_units} updates on the card held one at a time "
          f"against the CPU from the card's state and draws: every quantity within tolerance "
          f"(data rtol {LATE_DATA_RTOL}, atol {LATE_DATA_ATOL}; parameters rtol "
          f"{LATE_PARAM_RTOL}, atol {LATE_PARAM_ATOL}); worst (excess, |err|) {worst}; critic "
          f"loss {losses[0]:.4f} .. {losses[-1]:.4f}, alpha after {alphas}; warmup and an "
          f"update {warmup_s:.2f} s, state copied to the CPU in {copy_s:.2f} s, collect "
          f"{collect_s:.2f} s, updates {train_s:.2f} s, "
          f"{time.perf_counter() - t_all:.1f} s in all on {card}", flush=True)
    return {"late_hasac_card_vs_cpu": read_launches()}


def _to_cpu(x):
    """A tensor, or a NamedTuple of tensors, on the CPU."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    return type(x)(*[_to_cpu(v) for v in x])


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_all()
    errs = check_kernels("cuda")
    timing, floor = time_kernels("cuda")
    # Every timed run comes before the first torch.profiler session: a
    # session leaves the process slower (PERF.md §6).
    hasac_launches, hasac_profile = drive_hasac_path(card)
    launches, main_profile = drive_main_path(card)
    check_against_cpu()
    smac_launches, smac_gae, smac_profile = drive_smaclite_path(card)
    check_smaclite_against_cpu()
    for algo in ("hasac", "hatd3"):
        check_off_policy_against_cpu(algo)
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_runs_")
    try:
        cli_launches, cli_gae = drive_cli_hatrpo(card, os.path.join(log_dir, "hatrpo"), floor)
        cli_paths = drive_cli_paths(card, log_dir)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    check_family_against_cpu("hatrpo 3m FP GRU", "hatrpo", "smaclite", backtrack_coeff=0.5)
    check_family_against_cpu("hatrpo halfcheetah 2x3", "hatrpo", "mamujoco_jax")
    check_family_against_cpu("mappo share_param halfcheetah 2x3", "mappo", "mamujoco_jax",
                             share_param=True, ppo_epoch=2)
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_runs_")
    try:
        slice6 = drive_slice6_paths(card, log_dir)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    check_slice6_against_cpu()
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_runs_")
    try:
        slice7, ant_profile = drive_slice7_paths(card, log_dir)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    check_slice7_against_cpu()
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_runs_")
    try:
        slice8, handover_gae, slice8_profile = drive_slice8_paths(card, log_dir, floor)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    check_slice8_against_cpu()
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_runs_")
    try:
        slice9, slice9_gae, slice9_profile = drive_slice9_paths(card, log_dir, floor)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    check_slice9_against_cpu()
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_runs_")
    try:
        dp_paths, dp_gae = drive_dp_paths(card, floor, log_dir)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    check_dp_options_against_cpu()
    host_paths, host_gae = drive_host_paths(card, floor)
    check_host_against_cpu()
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_runs_")
    try:
        parity_paths, parity_gae = drive_parity_path(card, log_dir)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_runs_")
    try:
        multicard_paths, multicard_gae = drive_multicard_paths(card, floor, log_dir)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_runs_")
    try:
        replay_paths = drive_replay_scale_path(card, log_dir)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    late_paths = drive_late_hasac_path(card)
    for name, n in hasac_profile().items():
        hasac_launches[name] += n
    main_profile()
    smac_profile()
    ant_profile()
    slice8_profile()
    slice9_profile()
    by_path = {"halfcheetah": launches, "smaclite_fp": smac_launches, "hasac": hasac_launches,
               "cli_hatrpo_smaclite": cli_launches, **cli_paths, **slice6, **slice7, **slice8,
               **slice9, **dp_paths, **host_paths, **parity_paths, **multicard_paths,
               **replay_paths, **late_paths}
    kernels = []
    for name, _, _, _, replaces in kernel_cases():
        if launches[name] < 1:
            raise AssertionError(f"{name} was not launched on the main path")
        extra = {}
        if name == "gae":
            if smac_launches["gae"] < 1:
                raise AssertionError("gae was not launched on the SMACLite path")
            extra = dict(smaclite_in_situ=smac_gae, cli_hatrpo_in_situ=cli_gae,
                         shadowhandover_in_situ=handover_gae,
                         soccer_in_situ=slice9_gae["soccer_happo"],
                         aircombat_in_situ=slice9_gae["aircombat_happo"],
                         host_in_situ=host_gae, parity_in_situ=parity_gae,
                         **{f"dp_{k}_in_situ": v for k, v in dp_gae.items()},
                         **{f"{k}_in_situ": v for k, v in multicard_gae.items()})
        kernels.append(dict(
            name=name, route="cuda", source="harl_tpu_torch/csrc/gae.cu", replaces=replaces,
            launches=sum(p[name] for p in by_path.values()),
            launches_by_path={path: p[name] for path, p in by_path.items()},
            max_abs_err=max([errs[name]] + [v["max_abs_err"] for v in extra.values()]),
            ms=timing[name]["ms"],
            plain_ms=timing[name]["plain_ms"], bound_ms=timing[name]["bound_ms"],
            bound_by=timing[name]["bound_by"], library_ms=None,
            ms_cold=timing[name]["shapes"][0]["ms_cold"],
            host_us=timing[name]["shapes"][0]["host_us"],
            floor_ms=floor["ms"], floor_cold_ms=floor["cold_ms"],
            shapes=timing[name]["shapes"], **extra,
            parity=f"kernel == plain version at rtol {KERNEL_RTOL}, atol {KERNEL_ATOL}"))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
