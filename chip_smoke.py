#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``harl_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository, on a host with one CUDA device, the CUDA
toolkit (``nvcc``) and ``nvidia-smi``. Phases, each of which raises on failure:

1. require CUDA and print the card's name and power limit (``nvidia-smi``);
2. build the port's CUDA sources (``harl_tpu_torch/csrc/*.cu``) with ``nvcc``,
   one process per source, all started together;
3. hold every kernel against its plain PyTorch version on the card, at the
   main path's shape and at ragged shapes (tolerance below);
4. time every kernel, its plain version and its byte/operation bound;
5. drive the main path: HAPPO on planar HalfCheetah-6x1, 4096 envs × 32
   steps, MLP [64, 64], through ``OnPolicyRunner.train_iteration`` (3
   iterations; launch counts zeroed just before and read just after), then
   one ``use_gae: false`` iteration at 512 envs through the returns kernel;
6. profile one more main-path iteration with ``torch.profiler``: the
   device's busy share and its costliest kernels;
7. check one small iteration on the card against the same iteration on the
   CPU, from the same parameters and the same noise.

It prints one JSON line about the kernels, the ``nvidia-smi`` line, and as
its last line ``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
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
RETURNS_ENVS = 512


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
def returns_problem(T: int, trailing, with_bad: bool, seed: int, device):
    g = torch.Generator().manual_seed(seed)
    shape = (T,) + tuple(trailing)
    shape1 = (T + 1,) + tuple(trailing)
    rewards = torch.randn(shape, generator=g)
    values = torch.randn(shape1, generator=g)
    masks = (torch.rand(shape1, generator=g) > 0.15).float()
    bad = (torch.rand(shape1, generator=g) > 0.1).float() if with_bad else None
    to = lambda x: None if x is None else x.to(device)
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
    main_shape = (MAIN["episode_length"], (MAIN["n_envs"], 1))
    shapes = [main_shape, (9, (7, 1)), (9, (4, 3, 1)), (9, (130, 1)), (9, (5000, 1)),
              (1, (1, 1))]
    errs = {}
    for name, kern, plain, mk, _ in kernel_cases():
        for T, trailing in shapes:
            for with_bad in (True, False):
                args = mk(*returns_problem(T, trailing, with_bad, seed=T + len(trailing),
                                           device=device))
                out = kern(*args)
                torch.cuda.synchronize()
                ref = plain(*args)
                torch.testing.assert_close(out, ref, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
                if (T, trailing) == main_shape:
                    err = (out - ref).abs().max().item()
                    errs[name] = max(errs.get(name, 0.0), err)
        log(f"{name}: kernel == plain on {len(shapes) * 2} cases "
            f"(rtol {KERNEL_RTOL}, atol {KERNEL_ATOL}); main-shape max |err| {errs[name]:.3g}")
    return errs


def time_ms(fn, reps: int) -> tuple:
    """(device ms per call, wall ms per call).

    Device time: ``reps`` calls queued behind a spin kernel, between two
    CUDA events, so the host's cost of issuing them is hidden and the calls
    run back to back; median of 5 rounds. Wall time: one call at a time
    from an idle card, host cost and launch latency included; median of
    ``reps`` calls.
    """
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    device, wall = [], []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(3e9 * host_s) + 1000)  # ~1.5x the issue time at <= 2 GHz
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        device.append(a.elapsed_time(b) / reps)
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(device), statistics.median(wall)


def bound_ms(name: str, T: int, b: int) -> tuple:
    """Least time for the work at (T, b) with bad masks: every float the
    recursion needs read once (rewards T·b, values (T+1)·b, masks and bad
    rows 1..T, next_value b for the returns) and the output written once;
    against ~8 float32 operations per element."""
    floats = (T + (T + 1) + T + T + T) * b + (b if name == "discounted_returns" else 0)
    t_bytes = floats * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = 8 * T * b / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels(device) -> dict:
    from harl_tpu_torch.ops import gae_kernels as K

    T, trailing = MAIN["episode_length"], (MAIN["n_envs"], 1)
    b = math.prod(trailing)
    res = {}
    for name, kern, plain, mk, _ in kernel_cases():
        args = mk(*returns_problem(T, trailing, True, seed=7, device=device))
        before = getattr(K, name).launches
        ms, wall_ms = time_ms(lambda: kern(*args), reps=200)
        plain_ms, plain_wall_ms = time_ms(lambda: plain(*args), reps=20)
        getattr(K, name).launches = before  # timing launches are not the main path's
        bms, by = bound_ms(name, T, b)
        res[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
        print(f"{name} at T={T}, b={b}: kernel {ms * 1e3:.2f} us on the device "
              f"({wall_ms * 1e3:.2f} us a call from the host), plain version "
              f"{plain_ms * 1e3:.1f} us ({plain_wall_ms * 1e3:.1f} us), bound {bms * 1e3:.3f} us "
              f"({by}); no single PyTorch op computes the recurrence", flush=True)
    return res


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


def profile_iteration(runner, state, card: str, plain_iteration_s: float) -> None:
    """One more iteration under torch.profiler: kernels launched, device
    busy time (the sum of kernel and copy times: one stream, no overlap),
    and the busy share against an unprofiled iteration's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        runner.train_iteration(state)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:   # CPU ops also carry their kernels' time
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        rows.append((us, ev.count, ev.key))
    busy_s = sum(r[0] for r in rows) / 1e6
    if not rows:
        print(f"profile: no device time recorded by torch.profiler on {card}", flush=True)
        return
    launches = sum(r[1] for r in rows)
    print(f"profile of one iteration: {launches} device ops, device busy {busy_s:.4f} s, "
          f"busy share {busy_s / plain_iteration_s:.4f} of an unprofiled iteration "
          f"({plain_iteration_s:.4f} s) on {card}", flush=True)
    for us, count, key in sorted(rows, reverse=True)[:12]:
        print(f"  {us / 1e3:10.3f} ms {count:7d}x  {key[:90]}", flush=True)


def drive_main_path(card: str) -> dict:
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
    profile_iteration(runner, state, card, times[-1])

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
    return launches


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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_all()
    errs = check_kernels("cuda")
    timing = time_kernels("cuda")
    launches = drive_main_path(card)
    check_against_cpu()
    kernels = []
    for name, _, _, _, replaces in kernel_cases():
        if launches[name] < 1:
            raise AssertionError(f"{name} was not launched on the main path")
        kernels.append(dict(
            name=name, route="cuda", source="harl_tpu_torch/csrc/gae.cu", replaces=replaces,
            launches=launches[name], max_abs_err=errs[name], ms=timing[name]["ms"],
            plain_ms=timing[name]["plain_ms"], bound_ms=timing[name]["bound_ms"],
            bound_by=timing[name]["bound_by"], library_ms=None,
            parity=f"kernel == plain version at rtol {KERNEL_RTOL}, atol {KERNEL_ATOL}"))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
