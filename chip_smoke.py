#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``harl_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository, on a host with one CUDA device, the CUDA
toolkit (``nvcc``) and ``nvidia-smi``. Phases, each of which raises on failure,
run in the order 1-4, 10, 5, 7, 8, 9, 11, 12, 13, 14, 15, 16, 17, then the
torch.profiler sessions of 10, 6, 8, 16 and 17: a profiler session leaves
the process slower, so every timed run comes before the first one.

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
   block, 3 timed blocks (env-steps/s), one more block split into collect
   and train; last, 3 more timed blocks, the device ops of one env step
   with its actors and of one update, and one more block under
   torch.profiler; the launch counts are zeroed before each part and read
   after it (this path launches no kernel of the port);
11. check one small HASAC and one small HATD3 block (warmup, collect,
   train) on the card against the same blocks on the CPU: the buffer's rows
   and every parameter after training;
12. drive the CLI, ``harl_tpu_torch.train.main``, on the repo's tuned HATRPO
   config for SMACLite 5m_vs_6m at its full widths (20 envs x 160 steps, FP,
   GRU actors and critic, MLP [64, 64, 64]): 3 iterations with evaluation (10
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
   ops of one Humanoid and one ShadowHandOver env step.

It prints one JSON line about the kernels, the ``nvidia-smi`` line, and as
its last line ``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import functools
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
             timed_blocks=3)
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
    FP, GRU, MLP [64, 64, 64]): 3 iterations with evaluation and a
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
        run_dir = train.main(["--load_config", CLI_HATRPO, "--num_env_steps", str(3 * T * n),
                              "--eval_episodes", "10", *extra, "--log_dir", log_dir])
    wall = time.perf_counter() - t0
    launches = read_launches()
    if launches["gae"] < 3 or launches["discounted_returns"] != 0:
        raise AssertionError(f"cli hatrpo: launches {launches} (gae once an iteration)")
    recs = read_run(run_dir, 5)
    evals = [r for r in recs if "eval_return" in r]
    if not evals or not math.isfinite(evals[-1]["eval_return"]) or \
            "eval_win_rate" not in evals[-1]:
        raise AssertionError(f"cli hatrpo: eval records {evals}")
    if not os.path.isdir(os.path.join(run_dir, "models", f"ckpt_{3 * T * n}")):
        raise AssertionError(f"cli hatrpo: no ckpt_{3 * T * n}")
    times = [c[0] for c in its.calls]
    print(f"cli hatrpo smaclite: HATRPO 5m_vs_6m FP GRU, tuned config ({n} envs x {T} steps, "
          f"MLP {cfg_model_widths(its)}) through train.main: {len(times)} iterations of "
          f"{', '.join(f'{t:.4f}' for t in times)} s; {2 * n * T / sum(times[1:]):.1f} env-steps/s "
          f"over iterations 2-3; main {wall:.2f} s with eval (return "
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
    saved = checkpoint.restore_state(checkpoint.latest_checkpoint(run_dir), runner.device)
    saved_nets = [s["net"] for s in saved["state"]["actors"] + [saved["state"]["critic"]]]
    fresh_runner = OnPolicyRunner(runner.args, runner.algo_args, runner.env_args, device=device)
    fresh = net_copies(fresh_runner.restore(fresh_runner.init_state(7), run_dir))
    for nets in (restored, fresh):   # the resumed run's, and a fresh state's
        for sd, sd_saved in zip(nets, saved_nets):
            for k, v in sd.items():
                if not torch.equal(v, sd_saved[k]):
                    raise AssertionError(f"restore: {k} differs from the checkpoint")
    if len(its2.calls) != 1 or resumed_launches["gae"] != 1:
        raise AssertionError(f"resumed run: {len(its2.calls)} iterations, {resumed_launches}")
    read_run(run2, 5)
    trained = checkpoint.restore_state(checkpoint.latest_checkpoint(run2), runner.device)
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
    """One more rollout of an on-policy ``runner`` from ``state``, then the
    GAE kernel on that rollout's own returns inputs (of ``shape``, T first)
    held against its plain version and timed warm; its launches here are not
    counted. Returns the kernel's numbers on those inputs."""
    from harl_tpu_torch.ops import gae_kernels as K

    first_masks0 = state.carry.masks[:, 0]
    t0 = time.perf_counter()
    data = runner.rollout(state)
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


def make_family_runner(algo: str, env: str, device, noise, **algo_updates):
    """A small on-policy runner: 3m FP GRU or HalfCheetah 2x3."""
    from harl_tpu_torch.runners.on_policy import OnPolicyRunner
    from harl_tpu_torch.utils.config_tools import get_defaults_yaml_args

    algo_args, env_args = get_defaults_yaml_args(algo, env)
    algo_args["train"].update(n_rollout_threads=8, episode_length=10, num_env_steps=10 ** 9)
    algo_args["model"].update(hidden_sizes=[16, 16])
    algo_args["algo"].update(**algo_updates)
    if env == "smaclite":
        algo_args["model"].update(use_recurrent_policy=True, data_chunk_length=5)
        env_args.update(map_name="3m", state_type="FP", episode_limit=8)
    else:
        env_args.update(scenario="HalfCheetah-v2", agent_conf="2x3", episode_limit=5)
    return OnPolicyRunner({"algo": algo, "env": env}, algo_args, env_args, device=device,
                          noise=noise)


def check_family_against_cpu(label: str, algo: str, env: str, devices=("cpu", "cuda"),
                             **algo_updates) -> None:
    """Phase 14: one small iteration on the card and on the CPU from the
    same parameters and noise; HATRPO's accepted fractions are printed for
    both devices."""
    from harl_tpu_torch.utils.noise import GeneratorNoise

    runs = []
    for dev in devices:
        noise = GeneratorNoise(torch.Generator().manual_seed(6), dev)
        runner = make_family_runner(algo, env, dev, noise, **algo_updates)
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
    for name, n in hasac_profile().items():
        hasac_launches[name] += n
    main_profile()
    smac_profile()
    ant_profile()
    slice8_profile()
    by_path = {"halfcheetah": launches, "smaclite_fp": smac_launches, "hasac": hasac_launches,
               "cli_hatrpo_smaclite": cli_launches, **cli_paths, **slice6, **slice7, **slice8}
    kernels = []
    for name, _, _, _, replaces in kernel_cases():
        if launches[name] < 1:
            raise AssertionError(f"{name} was not launched on the main path")
        extra = {}
        if name == "gae":
            if smac_launches["gae"] < 1:
                raise AssertionError("gae was not launched on the SMACLite path")
            extra = dict(smaclite_in_situ=smac_gae, cli_hatrpo_in_situ=cli_gae,
                         shadowhandover_in_situ=handover_gae)
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
