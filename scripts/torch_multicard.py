#!/usr/bin/env python3
"""Data parallelism of the PyTorch/CUDA port across several cards over NCCL:
the port's counterpart of the JAX package's ``dryrun_multichip``
(``__graft_entry__.py``) and ``scripts/scaling_bench.py``.

    python3 scripts/torch_multicard.py [--world W] [--legs 1,2,3,4,5]
        [--platform cpu] [--out DIR]

Run it from the root of the repository on a host with W CUDA devices (all
of them unless ``--world`` says otherwise): one spawned rank a card, rank k
on ``cuda:k``, over NCCL. With fewer cards than asked it raises; it never
falls back to gloo or the CPU. ``--platform cpu`` runs the same legs on
gloo CPU ranks at tiny widths, to rehearse the script; its times are the
CPU's. It prints each card's name and power limit (``nvidia-smi``), ``nvidia-smi
topo -m`` and NCCL's version, then the legs:

1. the four program shapes of ``dryrun_multichip`` at its sizes, B = 2W
   envs: HAPPO on continuous MPE simple_spread (MLP), HAPPO on SMACLite 3m
   (FP, GRU), HASAC on continuous MPE simple_spread (warmup, collect,
   train) and MAPPO with ``share_param``, one step each on W ranks;
2. the bench's three workloads at their full global widths on W ranks
   (``chip_smoke.DP_WORKLOADS``: HalfCheetah-6x1 HAPPO 4096 x 32, SMACLite
   5m_vs_6m FP GRU HAPPO 256 x 70, HASAC at 256 envs and batch 1000), each
   step from the one-rank run's state. Legs 1 and 2 are held as phase 19
   of ``chip_smoke.py`` holds them (``chip_smoke.dp_check_ranks``): the
   replicas bitwise equal after every step, finite losses, first-step
   gradients at rtol 1e-5, atol 1e-6 and on-policy parameters within
   ``DP_PARAM_ATOL`` of the one-rank update of the ranks' own rows,
   gathered warmups and collects bitwise equal to each rank's share
   replayed, GAE launched once an iteration on each rank and held against
   its plain version on that rank's columns; their env-steps/s over the
   ranks against the one-rank run are the strong-scaling rates;
3. weak scaling at a fixed batch a rank, W = 1, 2, 4, ... (one spawn a W):
   HalfCheetah HAPPO 4096 envs x 32 steps, SMACLite FP HAPPO 256 x 70 (2
   warm-up and 5 timed iterations), HASAC 256 envs, batch 1000 a rank,
   buffer 200,000 (its warmup and one block, 3 timed blocks), once with
   every core a rank (torch's default) and once with cores // W; per W:
   env-steps/s over all ranks, efficiency rate_W / (W · rate_1),
   all-reduces a step and their ms (CUDA events), each rank's host wall a
   step and their spread, the rollout's seconds a rank, GAE in situ, and
   at the largest W rank 0's busy share from one profiled step after the
   timed ones;
4. the latency of ``Mesh.all_reduce_sum`` of one float32 buffer of one
   element, of a HalfCheetah actor's gradients ([64, 64]) and of a HASAC
   critic's ([256, 256]): the median of 100 calls at each W of leg 3 above 1;
5. the CLI on every card: ``python -m harl_tpu_torch.train --load_config
   tuned_configs/mamujoco_jax/HalfCheetah-v2-6x1/happo/config.json``
   without ``--n_devices`` (every card), 2 iterations with an evaluation
   and a checkpoint, then a resume from it; the two-host form, two
   processes of W/2 cards each (``--num_processes 2 --coordinator ...
   --process_id k --n_devices W/2``, each with its own
   ``CUDA_VISIBLE_DEVICES``); and, through ``run(mesh=…)`` on W ranks, how
   long the ranks wait while rank 0 evaluates alone, and a restore from the
   run's checkpoint bitwise equal to the state saved.

It prints the tables, writes every number into ``<out>/multicard.json``
and, as its last line, one JSON object of the tables' numbers. Any failed
check raises.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from chip_smoke import DPWorkload, sync  # noqa: E402

CLI_CONFIG = "tuned_configs/mamujoco_jax/HalfCheetah-v2-6x1/happo/config.json"
# per rank, the bench's widths on the card (bench.py:174-213, 252-285,
# 289-325) and tiny ones for the CPU rehearsal: (warm-up, timed) steps
WEAK = {
    "cuda": dict(halfcheetah=dict(n_envs=4096, T=32, hidden=[64, 64]),
                 smaclite_fp=dict(n_envs=256, T=70, hidden=[64, 64, 64], map_name="5m_vs_6m",
                                  chunk=10),
                 hasac=dict(n_envs=256, warmup_steps=256 * 4, train_interval=50,
                            batch_size=1000, buffer_size=200_000, hidden=[256, 256]),
                 depth=dict(on_policy=(2, 5), off_policy=(1, 3))),
    "cpu": dict(halfcheetah=dict(n_envs=2, T=8, hidden=[16, 16]),
                smaclite_fp=dict(n_envs=2, T=10, hidden=[16, 16], map_name="3m", chunk=5),
                hasac=dict(n_envs=2, warmup_steps=8, train_interval=4, batch_size=8,
                           buffer_size=400, hidden=[16, 16]),
                depth=dict(on_policy=(1, 2), off_policy=(1, 2))),
}
ALLREDUCE_CALLS = 100
CLI_TIMEOUT_S = 900


def log(msg: str) -> None:
    print(f"[torch_multicard {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


# ------------------------------------------------------------------ the host
def require_cards(world: int) -> None:
    """Raise unless ``world`` CUDA devices are visible: no fallback."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < world:
        raise RuntimeError(f"{world} cards asked for, {n} visible: the legs run one rank a "
                           "card over NCCL and fall back to nothing")


def card_lines() -> list:
    """``nvidia-smi --query-gpu=name,power.limit`` of every card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()


def topology() -> str:
    """``nvidia-smi topo -m``, or what it said where it failed (a host
    may not let it read the links)."""
    out = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode:
        return f"nvidia-smi topo -m exited {out.returncode}: {(out.stdout + out.stderr).strip()}"
    return out.stdout


def run_ranks(fn, world: int, args: tuple, platform: str, in_process: bool = False) -> list:
    """``fn(mesh, *args)`` on ``world`` ranks: spawned, one a card over
    NCCL (``--platform cpu``: gloo CPU ranks), or with ``in_process`` one
    rank in this process over a world-1 group on ``cuda:0``."""
    from harl_tpu_torch.parallel import mesh as dpmesh
    from harl_tpu_torch.parallel.launch import free_port, spawn_ranks

    backend = "gloo" if platform == "cpu" else "nccl"
    if not in_process:
        return spawn_ranks(fn, world, args, device=platform, backend=backend, timeout_s=1800)
    if world != 1:
        raise ValueError("in_process runs one rank")
    device = torch.device("cpu" if platform == "cpu" else "cuda:0")
    dpmesh.distributed_init(f"localhost:{free_port()}", 1, 0, backend)
    try:
        result = fn(dpmesh.make_mesh(device), *args)
        sync(device)
        return [result]
    finally:
        dpmesh.shutdown()


# ------------------------------------------------------- legs 1 and 2: exact
def dryrun_runner(shape: str, B: int, device):
    """One of ``dryrun_multichip``'s programs (``__graft_entry__.py:81-168``)
    at its sizes over B envs: "happo_mlp" (HAPPO, continuous MPE
    simple_spread, 4 steps, MLP [64, 64], 2 epochs), "happo_fp_gru" (HAPPO,
    SMACLite 3m FP, 10 steps, GRU [32, 32], chunks of 5), "hasac" (continuous
    simple_spread, warmup 12·B steps, blocks of 10, n_step 5, batch 32,
    buffer 2048, [32, 32]), "mappo_share_param" (the first with MAPPO and
    one shared policy)."""
    from harl_tpu_torch.runners.off_policy import OffPolicyRunner
    from harl_tpu_torch.runners.on_policy import OnPolicyRunner
    from harl_tpu_torch.utils.config_tools import get_defaults_yaml_args

    mpe = {"scenario": "simple_spread_v2", "continuous_actions": True}
    if shape == "hasac":
        algo_args, env_args = get_defaults_yaml_args("hasac", "pettingzoo_mpe")
        algo_args["train"].update(n_rollout_threads=B, num_env_steps=B * 100,
                                  warmup_steps=B * 12, train_interval=10, update_per_train=1)
        algo_args["algo"].update(n_step=5, batch_size=32, buffer_size=2048)
        algo_args["model"].update(hidden_sizes=[32, 32])
        env_args.update(mpe)
        return OffPolicyRunner({"algo": "hasac", "env": "pettingzoo_mpe"}, algo_args, env_args,
                               device=device)
    if shape == "happo_fp_gru":
        algo_args, env_args = get_defaults_yaml_args("happo", "smaclite")
        algo_args["train"].update(n_rollout_threads=B, episode_length=10,
                                  num_env_steps=B * 20)
        algo_args["model"].update(hidden_sizes=[32, 32], use_recurrent_policy=True,
                                  recurrent_n=1, data_chunk_length=5)
        algo_args["algo"].update(ppo_epoch=2, critic_epoch=2)
        env_args.update(map_name="3m", state_type="FP")
        return OnPolicyRunner({"algo": "happo", "env": "smaclite"}, algo_args, env_args,
                              device=device)
    algo = "mappo" if shape == "mappo_share_param" else "happo"
    algo_args, env_args = get_defaults_yaml_args(algo, "pettingzoo_mpe")
    algo_args["train"].update(n_rollout_threads=B, episode_length=4, num_env_steps=B * 8,
                              use_valuenorm=True, use_linear_lr_decay=False,
                              use_proper_time_limits=True)
    algo_args["model"].update(hidden_sizes=[64, 64], activation_func="relu",
                              use_feature_normalization=True,
                              initialization_method="orthogonal_", gain=0.01,
                              use_recurrent_policy=False, recurrent_n=1, lr=5e-4,
                              critic_lr=5e-4, opti_eps=1e-5, weight_decay=0.0, std_x_coef=1.0,
                              std_y_coef=0.5)
    algo_args["algo"].update(ppo_epoch=2, critic_epoch=2, use_clipped_value_loss=True,
                             clip_param=0.2, actor_num_mini_batch=1, critic_num_mini_batch=1,
                             entropy_coef=0.01, value_loss_coef=1.0, use_max_grad_norm=True,
                             max_grad_norm=10.0, use_gae=True, gamma=0.99, gae_lambda=0.95,
                             use_huber_loss=True, use_policy_active_masks=True,
                             huber_delta=10.0, action_aggregation="prod",
                             share_param=shape == "mappo_share_param", fixed_order=False)
    env_args.update(mpe)
    return OnPolicyRunner({"algo": algo, "env": "pettingzoo_mpe"}, algo_args, env_args,
                          device=device)


def dryrun_workloads(B: int) -> dict:
    """Leg 1: the four shapes over B envs, one step each (HASAC's warmup,
    collect and train from its initial state)."""
    return {f"dryrun_{shape}": DPWorkload(functools.partial(dryrun_runner, shape, B), steps)
            for shape, steps in (("happo_mlp", ("iteration",)),
                                 ("happo_fp_gru", ("iteration",)),
                                 ("hasac", ("warmup", "collect", "train")),
                                 ("mappo_share_param", ("iteration",)))}


def bench_workloads(platform: str, steps: dict = None) -> dict:
    """Leg 2: ``chip_smoke.DP_WORKLOADS`` on the card; on the CPU, the same
    three at tiny widths. ``steps`` cuts a workload's steps (by label)."""
    if platform == "cpu":
        w = {"halfcheetah": DPWorkload(functools.partial(smoke.make_runner, 8, 8, [16, 16]),
                                       ("iteration",) * 2),
             "smaclite_fp": DPWorkload(functools.partial(
                 smoke.make_smaclite_runner, 8, 10, [16, 16], map_name="3m",
                 data_chunk_length=5), ("iteration",)),
             "hasac": DPWorkload(functools.partial(
                 smoke.make_off_policy_runner, "hasac", n_envs=8, warmup_steps=32,
                 train_interval=4, batch_size=16, buffer_size=400, hidden=[16, 16]),
                 ("train", "collect", "train"), ("warmup", "collect"))}
    else:
        w = dict(smoke.DP_WORKLOADS)
    if steps:
        w = {label: w[label]._replace(steps=s) for label, s in steps.items()}
    return w


def leg_exact(card: str, world: int, platform: str, floor, log_dir: str, workloads: dict,
              tag: str, in_process: bool = False, where: str = None) -> tuple:
    """Legs 1 and 2 on ``world`` ranks: the one-rank runs here, the ranks'
    runs (one spawn for every workload), the checks of
    ``chip_smoke.dp_check_ranks``. Returns its (launches, in-situ, rates)."""
    device = "cpu" if platform == "cpu" else "cuda"
    states, ref = smoke.dp_reference(card, log_dir, workloads, device)
    t0 = time.perf_counter()
    ranks = run_ranks(smoke.dp_rank, world, (card, floor, states, workloads), platform,
                      in_process)
    log(f"{tag}: the {world} ranks' runs {time.perf_counter() - t0:.1f} s")
    where = where or (f"{world} gloo CPU ranks" if platform == "cpu" else
                      f"{world} ranks, one a card, over NCCL")
    return smoke.dp_check_ranks(card, ranks, states, ref, workloads, device, tag, where)


# ------------------------------------------------ legs 3 and 4: weak scaling
def weak_workloads(platform: str, world: int) -> dict:
    """Leg 3's runners at the global width of ``world`` ranks holding
    ``WEAK[platform]``'s envs (and batch) each; the buffer is replicated,
    so it keeps its size."""
    s = WEAK[platform]
    hc, sm, ha = s["halfcheetah"], s["smaclite_fp"], s["hasac"]
    return {
        "halfcheetah": functools.partial(smoke.make_runner, hc["n_envs"] * world, hc["T"],
                                         hc["hidden"]),
        "smaclite_fp": functools.partial(smoke.make_smaclite_runner, sm["n_envs"] * world,
                                         sm["T"], sm["hidden"], map_name=sm["map_name"],
                                         data_chunk_length=sm["chunk"]),
        "hasac": functools.partial(smoke.make_off_policy_runner, "hasac",
                                   n_envs=ha["n_envs"] * world,
                                   warmup_steps=ha["warmup_steps"] * world,
                                   train_interval=ha["train_interval"],
                                   batch_size=ha["batch_size"] * world,
                                   buffer_size=ha["buffer_size"], hidden=ha["hidden"]),
    }


def allreduce_sizes(platform: str) -> dict:
    """The element counts leg 4 reduces: one; a HalfCheetah-6x1 actor's
    parameters at [64, 64]; a HASAC critic's (its twin Qs) at [256, 256]."""
    hc = smoke.make_runner(2, 2, [64, 64], "cpu")
    state = hc.init_state(0)
    actor = sum(p.numel() for p in state.actors[0].net.parameters() if p.requires_grad)
    ha = smoke.make_off_policy_runner("hasac", "cpu", n_envs=2, batch_size=8, buffer_size=10,
                                      hidden=[256, 256])
    critic = sum(p.numel() for p in ha.init_state(0).critic.nets.parameters()
                 if p.requires_grad)
    return {"one": 1, "halfcheetah_actor_64x64": actor, "hasac_critic_256x256": critic}


def rank_host() -> dict:
    """This rank's cores (its affinity) and torch threads."""
    return dict(cores=len(os.sched_getaffinity(0)), threads=torch.get_num_threads())


def weak_drive(make, mesh, depth: tuple) -> tuple:
    """One workload of leg 3 on this rank: its runner at the global width,
    the warm-up and timed steps (iterations; for HASAC its warmup, then
    blocks of a collect and a train), each step's host wall ending in a
    sync, the rollout's (on-policy) or collect's and train's seconds, the
    all-reduces and their ms. Returns (record, (runner, state))."""
    from harl_tpu_torch.runners.off_policy import OffPolicyRunner

    dev = mesh.device
    runner = make(dev)
    runner.use_mesh(mesh)
    off = isinstance(runner, OffPolicyRunner)
    if mesh.grouped:
        mesh.all_reduce_sum([torch.zeros(1, device=dev)])   # set-up, untimed
        mesh.time_collectives = True
    state = runner.init_state(0)
    if off:
        state = runner.warmup_block(state)
    phases = []
    if not off:
        rollout = runner.rollout

        def timed_rollout(*args, **kwargs):
            t0 = time.perf_counter()
            out = rollout(*args, **kwargs)
            sync(dev)
            phases.append(time.perf_counter() - t0)
            return out

        runner.rollout = timed_rollout
    sync(dev)
    mesh.collective_ms()
    smoke.zero_launches()
    warm, timed = depth
    rec = dict(walls=[], phases=[], collectives=[], collective_ms=[])
    for i in range(warm + timed):
        calls = mesh.calls
        t0 = time.perf_counter()
        if off:
            state, _ = runner.collect_block(state)
            sync(dev)
            phases.append(time.perf_counter() - t0)
            state, m = runner.train_block(state)
        else:
            state, m = runner.train_iteration(state)
        sync(dev)
        wall = time.perf_counter() - t0
        ms = mesh.collective_ms()
        if i >= warm:
            rec["walls"].append(wall)
            rec["collectives"].append(mesh.calls - calls)
            rec["collective_ms"].append(ms)
            rec["phases"].append(phases[-1])
    bad = {k: float(v) for k, v in m.items()
           if torch.is_tensor(v) and v.dim() == 0 and not math.isfinite(float(v))}
    if bad:
        raise AssertionError(f"rank {mesh.rank}: not finite {bad}")
    rec.update(launches=smoke.read_launches(), off_policy=off,
               env_steps=(runner.train_interval if off else runner.episode_length)
               * runner.n_envs)
    want = warm + timed if dev.type == "cuda" and not off else 0
    if rec["launches"] != {"gae": want, "discounted_returns": 0}:
        raise AssertionError(f"rank {mesh.rank}: launches {rec['launches']} in {warm + timed} "
                             "steps (gae once an iteration on a card)")
    if not off:
        runner.rollout = rollout
    return rec, (runner, state)


def weak_rank(mesh, card: str, platform: str, plan: dict) -> dict:
    """Legs 3 and 4 on one rank of ``mesh.world``: every workload of leg 3
    in each threads mode ("all": every core of the rank's affinity, torch's
    own default; "split": its cores // W, what ``spawn_ranks`` and the CLI
    give a rank), then on a card GAE in situ on each
    on-policy workload's own inputs, the all-reduce latencies (leg 4, with
    ``plan["allreduce"]``) and, with ``plan["profile"]``, one more step of
    each workload with rank 0 under torch.profiler, after every timed run."""
    host = rank_host()
    modes = {"all": host["cores"], "split": max(1, host["cores"] // mesh.world)}
    if plan.get("modes"):
        modes = {k: modes[k] for k in plan["modes"]}
    print(f"rank {mesh.rank} of {mesh.world} on {mesh.device}: {host['cores']} cores in its "
          f"affinity, {host['threads']} torch threads as it starts; modes {modes}", flush=True)
    out = dict(host=host, modes={}, threads=modes)
    kept = {}
    makers = weak_workloads(platform, mesh.world) if plan.get("weak", True) else {}
    for mode, n in modes.items():
        same = [m for m in out["modes"] if modes[m] == n]
        if same:
            out["modes"][mode] = out["modes"][same[0]]    # the same threads: run once
            continue
        torch.set_num_threads(n)
        out["modes"][mode] = {}
        for label, make in makers.items():
            depth = WEAK[platform]["depth"]["off_policy" if label == "hasac" else "on_policy"]
            depth = plan.get("depth", {}).get(label, depth)
            t0 = time.perf_counter()
            rec, kept[label] = weak_drive(make, mesh, depth)
            out["modes"][mode][label] = rec
            if mesh.rank == 0:
                log(f"leg 3 W={mesh.world} {mode} threads ({n}) {label}: timed steps "
                    f"{[round(w, 4) for w in rec['walls']]} s, "
                    f"{time.perf_counter() - t0:.1f} s with its build and warm-up")
    torch.set_num_threads(host["threads"])
    out["gae"] = {}
    if mesh.device.type == "cuda" and plan.get("floor"):
        for label, (runner, state) in kept.items():
            if label == "hasac":
                continue
            T, n = runner.episode_length, runner.n_envs
            shape = (T, n, runner.n_agents, 1) if runner.fp else (T, n, 1)
            out["gae"][label] = smoke.gae_in_situ(
                f"weak {label} W={mesh.world} rank {mesh.rank}", runner, state, shape,
                plan["floor"], card)
    if plan.get("allreduce"):
        out["allreduce"] = allreduce_latency(mesh, plan["allreduce"])
    if plan.get("profile"):
        t0 = time.perf_counter()
        out["profile"] = {label: profiled_step(mesh, runner, state)
                          for label, (runner, state) in kept.items()}
        if mesh.rank == 0:
            log(f"leg 3 W={mesh.world}: profiled steps {time.perf_counter() - t0:.1f} s")
    return out


def allreduce_latency(mesh, sizes: dict, calls: int = ALLREDUCE_CALLS) -> dict:
    """Leg 4 on this rank: ``Mesh.all_reduce_sum`` of one float32 buffer of
    each size, 10 untimed calls, then ``calls`` each timed on the host's
    clock to a sync (and, on a card, between CUDA events): medians, µs.
    Each of those starts with the ranks as far apart as their hosts' last
    sync left them, so the same ``calls`` are also queued back to back
    after a barrier and timed as one (``back_to_back_us``, a call's mean):
    the collective's own time, the ranks' skew taken out."""
    dev = mesh.device
    mesh.time_collectives = dev.type == "cuda"
    out = {}
    for name, n in sizes.items():
        buf = torch.randn(n, device=dev)
        for _ in range(10):
            mesh.all_reduce_sum([buf])
        sync(dev)
        mesh.collective_ms()
        host, device = [], []
        for _ in range(calls):
            t0 = time.perf_counter()
            mesh.all_reduce_sum([buf])
            sync(dev)
            host.append((time.perf_counter() - t0) * 1e6)
            device.append(mesh.collective_ms() * 1e3)
        mesh.all_reduce_sum([buf])      # a barrier: every rank's queue is here
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(calls):
            mesh.all_reduce_sum([buf])
        sync(dev)
        queued = (time.perf_counter() - t0) * 1e6 / calls
        mesh.collective_ms()
        out[name] = dict(elements=n, host_us=statistics.median(host),
                         event_us=statistics.median(device) if dev.type == "cuda" else None,
                         back_to_back_us=queued)
    return out


def profiled_step(mesh, runner, state) -> dict:
    """One more step of a workload on every rank, rank 0's under
    torch.profiler: its device busy time (kernels and copies) over its
    wall."""
    from torch.profiler import ProfilerActivity, profile

    dev = mesh.device

    def step():
        if hasattr(runner, "train_block"):
            s, _ = runner.collect_block(state)
            runner.train_block(s)
        else:
            runner.train_iteration(state)
        sync(dev)

    sync(dev)
    if mesh.rank != 0 or dev.type != "cuda":
        step()
        return {}
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
    wall = time.perf_counter() - t0
    rows, _ = smoke.device_rows(prof)
    busy = sum(r[0] for r in rows.values()) / 1e6
    return dict(busy_s=busy, profiled_wall_s=wall, device_ops=sum(r[1] for r in rows.values()))


def scaling_rows(by_world: dict) -> list:
    """Leg 3's table rows from each W's ranks' records: env-steps/s over
    all ranks (the global env-steps of the timed steps over the slowest
    rank's wall), efficiency rate_W / (W · rate_1) in the same threads
    mode, all-reduces and their ms a step on rank 0, the largest spread of
    a step's wall across the ranks, rank 0's rollout (or collect) seconds
    a step, and rank 0's busy share (profiled step's busy time over the
    timed steps' mean wall)."""
    rows = []
    base = {}
    for world in sorted(by_world):
        ranks = by_world[world]
        for mode in ranks[0]["modes"]:
            for label in ranks[0]["modes"][mode]:
                recs = [r["modes"][mode][label] for r in ranks]
                r0 = recs[0]
                timed = len(r0["walls"])
                slowest = max(sum(r["walls"]) for r in recs)
                rate = world * r0["env_steps"] * timed / slowest
                if world == 1:
                    base[mode, label] = rate
                spread = [max(r["walls"][i] for r in recs) - min(r["walls"][i] for r in recs)
                          for i in range(timed)]
                prof = ranks[0].get("profile", {}).get(label) or {}
                mean_wall = statistics.mean(r0["walls"])
                rows.append(dict(
                    workload=label, world=world, mode=mode, threads=ranks[0]["threads"][mode],
                    env_steps_per_s=rate,
                    efficiency=rate / (world * base[mode, label]) if (mode, label) in base
                    else None,
                    env_steps_a_rank_a_step=r0["env_steps"], timed_steps=timed,
                    slowest_wall_s=slowest, mean_wall_s=mean_wall,
                    walls_by_rank=[r["walls"] for r in recs],
                    wall_spread_max_s=max(spread), wall_spread_median_s=statistics.median(spread),
                    allreduces_a_step=statistics.median(r0["collectives"]),
                    allreduce_ms_a_step=statistics.median(r0["collective_ms"]),
                    allreduce_ms_a_step_by_rank=[statistics.median(r["collective_ms"])
                                                 for r in recs],
                    phase_s_by_rank=[statistics.mean(r["phases"]) for r in recs],
                    busy_share=prof["busy_s"] / mean_wall if prof else None,
                    launches=[r["launches"] for r in recs]))
    return rows


def leg_scaling(card: str, world: int, platform: str, floor, profile: bool,
                sizes: dict, weak: bool = True) -> tuple:
    """Legs 3 and 4: one spawn a W of 1, 2, 4, ... up to ``world``, the
    largest profiled with ``profile``; without ``weak`` (leg 4 alone), the
    latencies only, at each W above 1.
    Returns (the rows of ``scaling_rows``, leg 4's medians by W, each W's
    ranks' hosts and GAE in situ)."""
    worlds = sorted({w for w in (1, 2, 4, 8, 16) if w <= world} | {world})
    if not weak:
        worlds = [w for w in worlds if w > 1]
    by_world = {}
    for w in worlds:
        # profiled at the largest W only: a profiled HASAC block alone
        # takes minutes to record
        plan = dict(floor=floor, profile=weak and profile and w == worlds[-1],
                    allreduce=sizes if w > 1 else None, weak=weak)
        if platform == "cpu":
            plan["modes"] = ["split"]     # the CPU's ranks: every core each would crawl
        t0 = time.perf_counter()
        by_world[w] = run_ranks(weak_rank, w, (card, platform, plan), platform)
        log(f"leg 3 at W={w}: {time.perf_counter() - t0:.1f} s with the spawn")
    latency = {w: [r["allreduce"] for r in ranks] for w, ranks in by_world.items()
               if "allreduce" in ranks[0]}
    extra = {w: dict(hosts=[r["host"] for r in ranks], gae=[r["gae"] for r in ranks])
             for w, ranks in by_world.items()}
    return scaling_rows(by_world), latency, extra


# ------------------------------------------------------------- leg 5: the CLI
def cli_argv(platform: str, iterations: int, world: int) -> list:
    """The tuned HalfCheetah-6x1 HAPPO config cut to ``iterations``; on the
    CPU at tiny widths on ``world`` gloo ranks."""
    if platform == "cpu":
        steps = iterations * 8 * 4
        return ["--load_config", CLI_CONFIG, "--platform", "cpu", "--n_devices", str(world),
                "--n_rollout_threads", "4", "--episode_length", "8", "--hidden_sizes",
                "[8, 8]", "--n_eval_rollout_threads", "2", "--eval_episodes", "2",
                "--episode_limit", "20", "--ppo_epoch", "1", "--critic_epoch", "1",
                "--num_env_steps", str(steps)]
    return ["--load_config", CLI_CONFIG, "--num_env_steps", str(iterations * 64 * 1024)]


def cli_rank(mesh, argv: list, save_dir: str) -> dict:
    """On each rank: the CLI's run through ``run(mesh=…)`` (its workers'
    code) with each iteration's wall timed to a sync, then the time from
    the last iteration to the end of the work queued after it (rank 0: its
    evaluation and checkpoint; the others: waiting in the checkpoint's
    gather), then a fresh state restored from the checkpoint, bitwise equal
    to the state saved, and one more iteration from it."""
    from harl_tpu_torch import train
    from harl_tpu_torch.parallel.mesh import tensors_of
    from harl_tpu_torch.runners import common
    from harl_tpu_torch.runners.on_policy import OnPolicyRunner

    args, algo_args, env_args = train.resolve_args(argv)
    dev = mesh.device
    runner = OnPolicyRunner(args, algo_args, env_args, device=dev)
    iteration = OnPolicyRunner.train_iteration
    ends, walls = [], []

    def timed(self, state):
        t0 = time.perf_counter()
        out = iteration(self, state)
        sync(dev)
        ends.append(time.perf_counter())
        walls.append(ends[-1] - t0)
        return out

    runner.train_iteration = functools.partial(timed, runner)
    state, history = runner.run(seed=algo_args["seed"]["seed"], save_dir=save_dir, mesh=mesh)
    sync(dev)
    tail = time.perf_counter() - ends[-1]
    # the checkpoint is on disk once rank 0 joins this all-reduce
    mesh.all_reduce_sum([torch.zeros(1, device=dev)])
    sync(dev)
    saved = [t.detach().clone() for t in common.replica_tensors(state) + tensors_of(state.carry)]
    restored = runner.restore(runner.init_state(7), save_dir)
    got = common.replica_tensors(restored) + tensors_of(restored.carry)
    differ = [i for i, (a, b) in enumerate(zip(got, saved))
              if not smoke.same_bits(a.cpu(), b.cpu())]
    # where a restored tensor lives on another device than the live one
    moved = sorted({f"{tuple(b.shape)} {b.device} -> {a.device}" for a, b in zip(got, saved)
                    if a.device != b.device})
    restored, m = iteration(runner, restored)
    return dict(walls=walls, tail_s=tail, restored_differ=differ, restored_tensors=len(got),
                moved=moved,
                mismatch_after=mesh.replica_mismatch(common.replica_tensors(restored)),
                value_loss=float(m["value_loss"]), evals=[h.get("eval_return") for h in history])


def run_cli(argv: list, log_dir: str, env: dict = None) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "harl_tpu_torch.train", *argv, "--log_dir", log_dir]
    return subprocess.Popen(cmd, cwd=REPO, env={**os.environ, **(env or {})},
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish(procs: list, what: str) -> list:
    """Each process's output once it exits; raises naming ``what`` where one
    failed or outlived ``CLI_TIMEOUT_S``."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CLI_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"{what}: exit codes {[p.returncode for p in procs]}\n" +
                             "\n".join(o[-4000:] for o in outs))
    return outs


def run_dirs(log_dir: str) -> list:
    return sorted(str(p) for p in Path(log_dir).rglob("seed-*") if p.is_dir())


def leg_cli(card: str, world: int, platform: str, log_dir: str) -> dict:
    """Leg 5: (a) ``run(mesh=…)`` on ``world`` ranks with the wait and the
    restore of ``cli_rank``; (b) the CLI on every card, 2 iterations with an
    evaluation (10 episodes, the config's 20 cut) and a checkpoint; (c) a
    resume of one more iteration from it; (d) two processes of W/2 cards
    each, process 0 alone writing the run directory."""
    out = {}
    # (a) the CLI's workers' code, timed on each rank
    argv = cli_argv(platform, 2, world) + ["--eval_interval", "2"]
    t0 = time.perf_counter()
    ranks = run_ranks(cli_rank, world, (argv, os.path.join(log_dir, "wait_ckpt")), platform)
    for r, res in enumerate(ranks):
        if res["restored_differ"] or res["moved"] or res["mismatch_after"] != (0, 0.0) or \
                not math.isfinite(res["value_loss"]):
            raise AssertionError(f"leg 5 (a) rank {r}: restored tensors {res['restored_differ']} "
                                 f"differ of {res['restored_tensors']}, on another device "
                                 f"{res['moved']}, mismatch after one "
                                 f"iteration {res['mismatch_after']}, value_loss "
                                 f"{res['value_loss']}")
    if ranks[0]["evals"][-1] is None or not math.isfinite(ranks[0]["evals"][-1]):
        raise AssertionError(f"leg 5 (a): rank 0's evaluations {ranks[0]['evals']}")
    wait = max(r["tail_s"] for r in ranks[1:]) if world > 1 else 0.0
    out["wait"] = dict(tail_s=[r["tail_s"] for r in ranks], walls=[r["walls"] for r in ranks],
                       longest_wait_s=wait, group_timeout_s=600.0)
    print(f"leg 5 (a) run(mesh=…) on {world} ranks, {CLI_CONFIG} cut to 2 iterations with an "
          f"evaluation and a checkpoint at the last: iterations "
          f"{[[round(x, 3) for x in r['walls']] for r in ranks]} s by rank; after the last, "
          f"rank 0 {ranks[0]['tail_s']:.2f} s (evaluation, return {ranks[0]['evals'][-1]:.3f}, "
          f"and checkpoint), the others waiting in the checkpoint's gather up to {wait:.2f} s "
          f"(the group's timeout 600 s); a fresh state restored from the checkpoint bitwise "
          f"equal ({ranks[0]['restored_tensors']} tensors on every rank, each on its live "
          f"tensor's device), one more iteration from it with the replicas bitwise equal, on "
          f"{card}", flush=True)
    log(f"leg 5 (a): {time.perf_counter() - t0:.1f} s")

    # (b) the CLI on every card, (c) resumed
    t0 = time.perf_counter()
    first = os.path.join(log_dir, "cli")
    (text,) = finish([run_cli(cli_argv(platform, 2, world) + ["--eval_interval", "2",
                                                               "--eval_episodes", "10"], first)],
                     "leg 5 (b) the CLI")
    wall = time.perf_counter() - t0
    (run_dir,) = run_dirs(first)
    if world > 1 and f"data parallelism over {world} ranks ({world} in this process)" not in text:
        raise AssertionError(f"leg 5 (b): the CLI did not train on {world} ranks:\n{text[-3000:]}")
    recs = smoke.read_run(run_dir, 6)
    steps = 2 * (64 * 1024 if platform != "cpu" else 32)
    trained = [r for r in recs if "value_loss" in r]
    evals = [r for r in recs if "eval_return" in r]
    if trained[-1]["steps"] != steps or not evals or \
            not math.isfinite(evals[-1]["eval_return"]):
        raise AssertionError(f"leg 5 (b): records {recs}")
    out["cli"] = dict(wall_s=wall, steps=steps, eval_return=evals[-1]["eval_return"],
                      fps=trained[-1]["fps"])
    print(f"leg 5 (b) python -m harl_tpu_torch.train --load_config {CLI_CONFIG} (no "
          f"--n_devices): {world} ranks, {steps} env-steps with an evaluation (return "
          f"{evals[-1]['eval_return']:.3f}) and checkpoint in {wall:.2f} s (fps "
          f"{out['cli']['fps']:.1f} in its last record) on {card}", flush=True)
    t0 = time.perf_counter()
    (text,) = finish([run_cli(cli_argv(platform, 1, world) + [
        "--use_eval", "False", "--model_dir", run_dir], os.path.join(log_dir, "resumed"))],
        "leg 5 (c) the resumed CLI")
    resumed = run_dirs(os.path.join(log_dir, "resumed"))
    if "restoring train state from" not in text or "params-only" in text or len(resumed) != 1:
        raise AssertionError(f"leg 5 (c): the resume did not restore the full state:\n"
                             f"{text[-3000:]}")
    smoke.read_run(resumed[0], 6)
    out["resume_wall_s"] = time.perf_counter() - t0
    print(f"leg 5 (c) the same with --model_dir: the full state restored on {world} ranks, one "
          f"more iteration, {out['resume_wall_s']:.2f} s", flush=True)

    # (d) two processes of world/2 cards each, as two hosts
    if world < 2 or world % 2:
        return out
    half = world // 2
    from harl_tpu_torch.parallel.launch import free_port

    coordinator = f"localhost:{free_port()}"
    argv = cli_argv(platform, 1, half) + ["--use_eval", "False", "--num_processes", "2",
                                          "--coordinator", coordinator]
    if platform != "cpu":
        argv += ["--n_devices", str(half)]
    t0 = time.perf_counter()
    procs = []
    for k in range(2):
        # each process its own cards: both would take cuda:0.. otherwise
        env = (None if platform == "cpu" else
               {"CUDA_VISIBLE_DEVICES": ",".join(str(c) for c in range(k * half,
                                                                      (k + 1) * half))})
        procs.append(run_cli(argv + ["--process_id", str(k)], os.path.join(log_dir, f"host{k}"),
                             env))
    texts = finish(procs, "leg 5 (d) two processes")
    hosts = [run_dirs(os.path.join(log_dir, f"host{k}")) for k in range(2)]
    if len(hosts[0]) != 1 or hosts[1] or \
            f"data parallelism over {world} ranks ({half} in this process)" not in texts[0]:
        raise AssertionError(f"leg 5 (d): run dirs {hosts}:\n{texts[0][-3000:]}")
    smoke.read_run(hosts[0][0], 6)
    out["two_processes_wall_s"] = time.perf_counter() - t0
    print(f"leg 5 (d) two processes, --num_processes 2 --n_devices {half}, each with its own "
          f"CUDA_VISIBLE_DEVICES: {world} ranks, process 0 alone wrote the run directory, "
          f"{out['two_processes_wall_s']:.2f} s", flush=True)
    return out


# ------------------------------------------------------------------ tables
def fmt(x, spec: str = ".1f") -> str:
    return "—" if x is None else format(x, spec)


def tables(results: dict, cards: list) -> str:
    lines = []
    card = "; ".join(sorted(set(cards)))
    if results.get("scaling", {}).get("rows"):
        lines += [f"Weak scaling ({card}):", "",
                  "| Workload | W | Threads | env-steps/s, all ranks | Efficiency | All-reduces "
                  "a step | Their ms a step (rank 0) | Step wall, rank 0 (s) | Spread across "
                  "ranks, max (s) | Rollout or collect s, by rank | Busy share, rank 0 |",
                  "| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |"]
        for r in results["scaling"]["rows"]:
            lines.append(
                f"| {r['workload']} | {r['world']} | {r['mode']} ({r['threads']}) | "
                f"{r['env_steps_per_s']:.1f} | {fmt(r['efficiency'], '.3f')} | "
                f"{r['allreduces_a_step']:g} | {r['allreduce_ms_a_step']:.3f} | "
                f"{r['mean_wall_s']:.4f} | {r['wall_spread_max_s']:.4f} | "
                f"{', '.join(f'{x:.4f}' for x in r['phase_s_by_rank'])} | "
                f"{fmt(r['busy_share'], '.4f')} |")
    if "scaling" in results:
        lat = results["scaling"]["allreduce"]
        if lat:
            lines += ["", f"All-reduce latency, median of {ALLREDUCE_CALLS} calls ({card}):", "",
                      "| Buffer | Elements | W | Host µs to a sync, rank 0 (max over ranks) | "
                      "Device µs (CUDA events), rank 0 | Back to back, µs a call, rank 0 |",
                      "| --- | --- | --- | --- | --- | --- |"]
            for w, ranks in sorted(lat.items()):
                for name, v in ranks[0].items():
                    worst = max(r[name]["host_us"] for r in ranks)
                    lines.append(f"| {name} | {v['elements']} | {w} | {v['host_us']:.1f} "
                                 f"({worst:.1f}) | {fmt(v['event_us'])} | "
                                 f"{v['back_to_back_us']:.1f} |")
    if "exact" in results:
        lines += ["", f"Strong scaling, legs 1 and 2 ({card}):", "",
                  "| Workload | W | env-steps/s, all ranks | One rank | Ratio | Step s, by rank "
                  "| All-reduces (ms) a step, rank 0 |",
                  "| --- | --- | --- | --- | --- | --- | --- |"]
        for label, r in results["exact"]["rates"].items():
            steps = "; ".join(", ".join(f"{x:.4f}" for x in s) for s in r["seconds"])
            colls = ", ".join(f"{c} ({m:.3f})" for c, m in zip(r["collectives"],
                                                              r["collective_ms"]))
            lines.append(
                f"| {label} | {len(r['seconds'])} | {r['env_steps_per_s']:.1f} | "
                f"{r['one_rank_env_steps_per_s']:.1f} | "
                f"{r['env_steps_per_s'] / r['one_rank_env_steps_per_s']:.3f} | {steps} | "
                f"{colls} |")
    return "\n".join(lines)


def summary(results: dict) -> dict:
    """The tables' numbers, for the last line."""
    out = {}
    if "scaling" in results:
        out["weak"] = [{k: r[k] for k in ("workload", "world", "mode", "threads",
                                           "env_steps_per_s", "efficiency",
                                           "allreduces_a_step", "allreduce_ms_a_step",
                                           "wall_spread_max_s", "busy_share")}
                       for r in results["scaling"]["rows"]]
        out["allreduce_us"] = {str(w): {k: v["host_us"] for k, v in ranks[0].items()}
                               for w, ranks in results["scaling"]["allreduce"].items()}
    if "exact" in results:
        out["strong"] = {k: dict(env_steps_per_s=v["env_steps_per_s"],
                                 one_rank=v["one_rank_env_steps_per_s"])
                         for k, v in results["exact"]["rates"].items()}
    if "cli" in results:
        out["cli_longest_wait_s"] = results["cli"]["wait"]["longest_wait_s"]
    return out


# -------------------------------------------------------------- phase 22
def smoke_phase(card: str, floor: dict, log_dir: str) -> tuple:
    """``chip_smoke.py``'s phase 22 on its one card: legs 1, 3 (cut to one
    warm-up and one timed step, HASAC its warmup and one block, in one
    threads mode, not profiled) and 4 on one rank over a world-1 NCCL
    group in this process; legs 1 and 2 (HalfCheetah and SMACLite, one
    iteration each; HASAC's gathers are leg 1's) on 4 gloo ranks sharing
    ``cuda:0``. Returns (launches by path, the GAE kernel's in-situ numbers
    by path)."""
    from harl_tpu_torch.parallel.launch import spawn_ranks

    by_path, in_situ = {}, {}
    t0 = time.perf_counter()
    paths, _, _ = leg_exact(card, 1, "cuda", None, os.path.join(log_dir, "w1"),
                            dryrun_workloads(2), "phase 22 leg 1", in_process=True,
                            where="one rank over a world-1 NCCL group")
    by_path.update({f"multicard_w1_{k}": v for k, v in paths.items()})
    plan = dict(floor=floor, profile=False, modes=["split"], allreduce=allreduce_sizes("cuda"),
                depth={"halfcheetah": (1, 1), "smaclite_fp": (1, 1), "hasac": (0, 1)})
    (res,) = run_ranks(weak_rank, 1, (card, "cuda", plan), "cuda", in_process=True)
    for label, rec in res["modes"]["split"].items():
        by_path[f"multicard_w1_weak_{label}"] = rec["launches"]
        print(f"phase 22 leg 3 {label}: one rank over a world-1 NCCL group, "
              f"{rec['env_steps'] / rec['walls'][0]:.1f} env-steps/s, {rec['collectives'][0]} "
              f"all-reduces ({rec['collective_ms'][0]:.3f} ms) a step on {card}", flush=True)
    in_situ.update({f"multicard_w1_weak_{k}": v for k, v in res["gae"].items()})
    print(f"phase 22 leg 4: all-reduce of one float32 buffer over a world-1 NCCL group, median "
          f"of {ALLREDUCE_CALLS}: " + ", ".join(
              f"{k} ({v['elements']}) {v['host_us']:.1f} us to a sync, {v['event_us']:.1f} us "
              f"on the device" for k, v in res["allreduce"].items()) + f" on {card}", flush=True)
    log(f"phase 22 on one rank: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    workloads = {**dryrun_workloads(8), **bench_workloads(
        "cuda", {"halfcheetah": ("iteration",), "smaclite_fp": ("iteration",)})}
    states, ref = smoke.dp_reference(card, os.path.join(log_dir, "w4"), workloads)
    ranks = spawn_ranks(smoke.dp_rank, 4, (card, floor, states, workloads), device="cuda:0",
                        backend="gloo", timeout_s=600)
    paths, gae, _ = smoke.dp_check_ranks(
        card, ranks, states, ref, workloads, "cuda", "phase 22 legs 1-2",
        "4 gloo ranks sharing the one card (not a scaling number)")
    by_path.update({f"multicard_gloo4_{k}": v for k, v in paths.items()})
    in_situ.update({f"multicard_gloo4_{k}": v for k, v in gae.items()})
    log(f"phase 22 on 4 gloo ranks: {time.perf_counter() - t0:.1f} s with the spawn")
    return by_path, in_situ


# --------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (cards); every visible card by default, 2 on the CPU")
    ap.add_argument("--legs", default="1,2,3,4,5")
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="results/multicard")
    args = ap.parse_args(argv)
    legs = {int(x) for x in args.legs.split(",")}
    platform = args.platform
    if platform == "cuda":
        world = args.world or torch.cuda.device_count()
        require_cards(max(world, 1))
        smoke.build_all()
        cards = card_lines()
        for i, line in enumerate(cards):
            print(f"card {i}: {line}", flush=True)
        print(topology(), flush=True)
        print(f"NCCL {torch.cuda.nccl.version()}; torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}", flush=True)
        floor = dict(ms=smoke.time_warm(lambda: torch.cuda._sleep(1), reps=200)[0])
        card = cards[0] if len(set(cards[:world])) == 1 else "; ".join(cards[:world])
    else:
        world = args.world or 2
        cards, card, floor = ["cpu"], "cpu", None
    results = dict(world=world, platform=platform, cards=cards[:world])
    with tempfile.TemporaryDirectory(prefix="torch_multicard_") as log_dir:
        if legs & {1, 2}:
            workloads = {}
            if 1 in legs:
                workloads.update(dryrun_workloads(2 * world))
            if 2 in legs:
                workloads.update(bench_workloads(platform))
            by_path, in_situ, rates = leg_exact(card, world, platform, floor,
                                                os.path.join(log_dir, "exact"), workloads,
                                                "legs 1-2")
            results["exact"] = dict(launches=by_path, gae=in_situ, rates=rates)
        if legs & {3, 4}:
            sizes = allreduce_sizes(platform) if 4 in legs else None
            rows, latency, extra = leg_scaling(card, world, platform, floor,
                                               platform == "cuda", sizes, 3 in legs)
            results["scaling"] = dict(rows=rows, allreduce=latency, ranks=extra)
        if 5 in legs:
            results["cli"] = leg_cli(card, world, platform, os.path.join(log_dir, "cli"))
    text = tables(results, cards[:world])
    print(text, flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "multicard.json"), "w") as f:
        json.dump(results, f, indent=1, default=str)
    print(json.dumps(summary(results)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
