#!/usr/bin/env python3
"""Learning parity of the PyTorch/CUDA port: train the runs behind the JAX
package's recorded learning results through ``harl_tpu_torch.train.main``,
with several seeds, and hold each run against its record.

    python scripts/torch_learning_parity.py [--runs NAME,...] [--seeds 1,2,3]
        [--jobs N] [--ranks N] [--iterations N] [--platform cpu]
        [--out validation_torch] [--log_dir DIR] [--table] [--jax]
        [--spread NAME] [-- EXTRA ARGV]

Run it from the root of the repository (the run table's paths are
relative to it). ``RUNS`` holds one entry a run: the argv of the JAX command that produced
the record (``scripts/r3_queue5.sh:12-21``; round 1 of ``VALIDATION.md``
for HalfCheetah HAPPO; ``scripts/r2_queue.sh:13`` for HalfCheetah HASAC,
cut at the step where that run's time limit cut it; ``scripts/r2_tail.sh:20``
and ``scripts/r3_queue5.sh:51-58`` for MPE simple_spread's HAPPO, MAPPO,
HAA2C and HAD3QN), the GAE shape the run gives the kernel (None for an
off-policy run, which launches none), and the record itself, as read from
``validation/r3/*_won.csv``, ``validation/r2/cheetah6x1_hasac_train.csv``,
the MPE runs' ``*_eval.csv`` or ``VALIDATION.md``
(``tests/test_torch_learning_parity.py`` holds the two equal). Each run
takes ``--seed s`` for every seed asked for; seed 1 is the JAX runs' seed.

Every (run, seed) trains in a child process of its own, so that its peak
memory is its own; ``--jobs N`` runs N children at once on the one card
(the paths are host-bound), and each record says how many ran beside it
(``concurrent``). With ``--ranks N`` each run trains data-parallel over N
ranks, one child process a rank (``--num_processes N --process_id k
--n_devices 1``), rank k on card k mod the cards visible (its own
``CUDA_VISIBLE_DEVICES``); rank 0 writes the run's files, every rank
holds its GAE launches and in-situ error, and the record says how many
ranks and cards the run used (``ranks``, ``cards``; a record without them
is one rank on one card). The runs use CUDA unless ``--platform cpu`` is given;
without a CUDA device the script exits non-zero. ``--iterations N`` cuts
every run to N iterations, or N blocks of ``train_interval`` steps after
the warmup for the off-policy run (a rate measurement or a rehearsal);
the words after ``--`` are appended to every run's argv (narrow widths on
the CPU).

From each run's ``logs/progress.txt`` a child writes, into ``--out``,
``<run>_s<seed>_{eval,won,mean_step_reward,mean_episode_return}.csv``
(``steps,value``, as ``scripts/harvest_r3.py`` writes them; ``won`` from
the evaluations' score rate, the other two from the training records) and
``<run>_s<seed>.json``: the card's name and power limit (``nvidia-smi``),
the run's wall time and env-steps/s over all of it (evaluations and
checkpoints included), each iteration's (off-policy: each collect and
train block's) and each evaluation's seconds, peak
``torch.cuda.max_memory_allocated`` and peak RSS, the GAE kernel's
launches an iteration, its max |err| against ``gae_reference`` on the
run's own inputs at the first iteration (bound: 1e-5 of the largest
return) with its warm time and byte bound there, and the run's values at
the record's steps. An off-policy run launches no GAE kernel: it must
launch it 0 times, and records instead the replay ring's rows at the end,
which must equal min(warmup + steps, buffer_size), under discrete actions
its availability rows, each of which must be written, and at every log
record (``learners``, also printed to the run's log) each agent's α, the
critic's α (None where the algorithm has none, as HAD3QN), the last train
block's critic loss and, for each agent, the share of the raw log-std
elements below the squashed Gaussian's floor (``LOG_STD_MIN``) in the
samples its actor's loss was taken through since the last record (None
without a squashed Gaussian).

The rule: a run **meets** its record when, at every step the record
names, the median of the port's seeds is no lower than the record less a
tolerance: 0.05 absolute for a score rate, 10 % of the record for
HalfCheetah's ``mean_step_reward`` and for an episode return. An MPE
run's record is windowed: each point is the mean of the JAX run's five
evaluations ending at its step (a single 20-episode evaluation is noisy),
a seed's value the mean of its own evaluations at those five steps, and a
seed that lacks any of them has not reached the point; the rule is the
return's. Higher than
the record is fine: each record is one seed. A run whose seeds did not reach a record's step is
``cut``. The script prints one row a run with each seed's value, the
median, the record and the verdict, and exits non-zero if a child failed.

``--jax`` trains the JAX package's runs instead, on the CPU: each (run,
seed) is the JAX CLI (``python -m harl_tpu.train``, a child process; this
script imports no JAX) with the record's own argv, only ``--seed`` and,
with ``--iterations``, the budget changed, ``JAX_PLATFORMS=cpu`` and a
compile cache of its own under ``--log_dir``; its curves and a record
(the argv, the JAX version, the CPU's model and cores, the wall and the
most JAX runs at once during it) go into ``--out``. ``--spread NAME``
prints a second reading of a record beside its verdict, which it does not
change (``SPREAD``): at each record step, the JAX values (its CPU seeds
and the TPU record) against the port's seeds. The port is **within JAX's
spread** at a step when its median lies in the range of the JAX values
and the two-sided Mann-Whitney U test of its seeds against them gives p of
at least ``SPREAD_P``; a step that a side did not reach is not measured.
"""
from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import os
import resource
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

ACADEMY = ("--n_rollout_threads", "256", "--num_env_steps", "5000000", "--log_interval", "10",
           "--eval_interval", "50")


def _academy(scenario: str) -> tuple:
    return ("--load_config", f"tuned_configs/football_jax/{scenario}/happo/config.json",
            *ACADEMY)


def _mpe(actions: str, algo: str, steps: int) -> tuple:
    return ("--load_config", f"tuned_configs/pettingzoo_mpe/simple_spread_v2-{actions}/{algo}/"
            "config.json", "--num_env_steps", str(steps))


# name: argv of the JAX run, the GAE shape (T, b) in situ, the metric, and
# the record as ((step, value), ...) with its source; with ``window`` (k,
# every), each value is the mean of the JAX run's k evaluations, ``every``
# env-steps apart, that end at the step
RUNS = {
    "football_pass_and_shoot_with_keeper": dict(
        argv=_academy("academy_pass_and_shoot_with_keeper"), shape=(200, 256), metric="won",
        record=((2560000, 1.0), (4966400, 0.997)),
        source="validation/r3/football_pass_and_shoot_with_keeper_won.csv"),
    "football_run_pass_and_shoot_with_keeper": dict(
        argv=_academy("academy_run_pass_and_shoot_with_keeper"), shape=(200, 256),
        metric="won", record=((2560000, 0.995), (4966400, 1.0)),
        source="validation/r3/football_run_pass_and_shoot_with_keeper_won.csv"),
    "football_counterattack_easy": dict(
        argv=_academy("academy_counterattack_easy"), shape=(200, 256), metric="won",
        record=((2560000, 0.989), (4966400, 0.992)),
        source="validation/r3/football_counterattack_easy_won.csv"),
    "football_3v1_pixels": dict(
        argv=("--algo", "happo", "--env", "football_jax", "--env_name",
              "academy_3_vs_1_with_keeper", "--representation", "pixels", "--num_env_steps",
              "3000000", "--n_rollout_threads", "128", "--episode_length", "128",
              "--log_interval", "10", "--eval_interval", "30", "--eval_episodes", "64",
              "--n_eval_rollout_threads", "64"),
        shape=(128, 128), metric="won", record=((2998272, 0.934),),
        source="validation/r3/football_3v1_pixels_won.csv"),
    "halfcheetah_6x1_happo": dict(
        argv=("--load_config", "tuned_configs/mamujoco_jax/HalfCheetah-v2-6x1/happo/config.json",
              "--num_env_steps", "4000000"),
        shape=(64, 1024), metric="mean_step_reward", record=((3997696, 4.0),),
        source="VALIDATION.md:575 (round 1)"),
    # the JAX run's time limit cut it after 800 blocks of 1,000 env-steps:
    # the last record at 10,000 (warmup) + 800 x 1,000
    "halfcheetah_6x1_hasac": dict(
        argv=("--load_config", "tuned_configs/mamujoco_jax/HalfCheetah-v2-6x1/hasac/config.json",
              "--num_env_steps", "800000"),
        shape=None, metric="mean_episode_return",
        record=((210000, 2072.57), (410000, 5116.86), (610000, 5590.83), (810000, 5782.47)),
        source="validation/r2/cheetah6x1_hasac_train.csv"),
    # MPE simple_spread: the JAX runs of scripts/r2_tail.sh:20 and
    # scripts/r3_queue5.sh:51-58, held at the middle and the end of the budget
    "mpe_spread_happo": dict(
        argv=_mpe("continuous", "happo", 4000000), shape=(200, 20), metric="eval",
        window=(5, 100000), record=((2000000, -68.102), (4000000, -58.112)),
        source="validation/r2/mpe_spread_happo_eval.csv"),
    "mpe_spread_mappo": dict(
        argv=_mpe("continuous", "mappo", 4000000), shape=(200, 20), metric="eval",
        window=(5, 100000), record=((2000000, -79.894), (4000000, -77.762)),
        source="validation/r3/mpe_spread_mappo_eval.csv"),
    "mpe_spread_haa2c": dict(
        argv=_mpe("continuous", "haa2c", 4000000), shape=(200, 20), metric="eval",
        window=(5, 100000), record=((2000000, -106.41), (4000000, -109.252)),
        source="validation/r3/mpe_spread_haa2c_eval.csv",
        note="the JAX run barely learned: -103.62 at its first evaluation"),
    "mpe_spread_had3qn": dict(
        argv=_mpe("discrete", "had3qn", 3000000), shape=None, metric="eval",
        window=(5, 20000), record=((1510000, -69.1832), (3010000, -62.4823)),
        source="validation/r3/mpe_spread_had3qn_eval.csv"),
}
# the score rate's tolerance (absolute) and a reward's or return's (of the record)
RATE_TOL = 0.05
REWARD_TOL = 0.10
# in-situ GAE: max |kernel - plain| at most this much of the largest return
GAE_REL_BOUND = 1e-5


def window_steps(name: str, step: int) -> list:
    """The steps whose evaluations a record point of ``name`` averages:
    the step alone, or the window of k evaluations ending there."""
    k, every = RUNS[name].get("window", (1, 0))
    return [step - j * every for j in range(k - 1, -1, -1)]


def value_at(name: str, curve: dict, step: int):
    """A seed's value at a record point from its curve {step: value}: the
    mean over the point's window, None where the curve lacks any of its
    steps (the seed has not reached the point)."""
    steps = window_steps(name, step)
    if any(s not in curve for s in steps):
        return None
    return statistics.fmean(curve[s] for s in steps)


def tolerance(metric: str, record: float) -> float:
    return RATE_TOL if metric == "won" else REWARD_TOL * abs(record)


def verdict(metric: str, values: list, record: float) -> tuple:
    """(median, "meets" or "misses") of the seeds' ``values`` against one
    point of the record; ("cut") where no seed reached it."""
    if not values:
        return None, "cut"
    med = statistics.median(values)
    return med, "meets" if med >= record - tolerance(metric, record) else "misses"


@functools.cache
def _chip_smoke():
    """``chip_smoke.py`` as a module: its card line, byte bound and warm
    timing, so that the in-situ numbers are taken as its phases take them."""
    spec = importlib.util.spec_from_file_location("chip_smoke_parity", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


class Instruments:
    """For the duration of a ``with``: each ``train_iteration``'s (each
    off-policy collect and train block's) and each evaluation's seconds,
    the replay ring's rows after the last train block, at each off-policy
    log record the α of every agent and of the critic (auto-α), the
    last train block's critic loss and each agent's share of raw log-std
    elements below ``LOG_STD_MIN`` in its actor's loss samples since the
    last record (``learners``), and on the first GAE
    call of the run the kernel held against ``gae_reference`` on its own
    inputs (and, on CUDA, timed warm; those launches are not counted)."""

    def __init__(self, device: str):
        self.device = device
        self.iteration_s, self.eval_s, self.in_situ, self.ring_rows = [], [], None, None
        self.collect_s, self.train_s, self.learners = [], [], []
        self.off_state = self.off_loss = self.pending = self.discrete = None
        self.clamped = {}    # id(actor state): (log-std elements below the floor, elements)

    def __enter__(self):
        import torch

        from harl_tpu_torch.logging.logger import TrainLogger
        from harl_tpu_torch.ops import distributions as D
        from harl_tpu_torch.ops import gae_kernels as K
        from harl_tpu_torch.runners import off_policy, on_policy

        Off = off_policy.OffPolicyRunner
        self.saved = [(on_policy, "compute_gae", on_policy.compute_gae),
                      (on_policy.OnPolicyRunner, "train_iteration",
                       on_policy.OnPolicyRunner.train_iteration),
                      (on_policy.OnPolicyRunner, "evaluate", on_policy.OnPolicyRunner.evaluate),
                      (Off, "collect_block", Off.collect_block),
                      (Off, "train_block", Off.train_block), (Off, "evaluate", Off.evaluate),
                      (TrainLogger, "log_episode", TrainLogger.log_episode),
                      (D, "squashed_gaussian_sample", D.squashed_gaussian_sample),
                      (Off, "_step_actor", Off._step_actor)]
        ((_, _, compute_gae), (_, _, train_iteration), (_, _, evaluate),
         (_, _, collect_block), (_, _, train_block), (_, _, off_evaluate),
         (_, _, log_episode), (_, _, sample), (_, _, step_actor)) = self.saved

        def sync():
            if self.device == "cuda":
                torch.cuda.synchronize()

        def timed(fn, into):
            def wrapped(*args, **kwargs):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                sync()
                into.append(time.perf_counter() - t0)
                return out
            return wrapped

        def checked_gae(rewards, values, masks, bad, gamma, lam, impl=None):
            out = compute_gae(rewards, values, masks, bad, gamma, lam, impl)
            if self.in_situ is None and impl is None:
                args = (rewards.contiguous(), values.contiguous(), masks.contiguous(),
                        None if bad is None else bad.contiguous(), gamma, lam)
                ref = K.gae_reference(*args)
                T, b = rewards.shape[0], rewards.numel() // rewards.shape[0]
                bound, by = _chip_smoke().bound_ms("gae", T, b)
                self.in_situ = dict(T=T, b=b, max_abs_err=(out - ref).abs().max().item(),
                                    max_abs_return=ref.abs().max().item(),
                                    bound_ms=bound, bound_by=by, ms=None)
                if self.device == "cuda":
                    before = K.gae.launches
                    self.in_situ["ms"] = _chip_smoke().time_warm(lambda: K.gae(*args), 200)[0]
                    K.gae.launches = before
            return out

        def counted_train_block(runner, state):
            out = train_block(runner, state)
            self.ring_rows = out[0].buffer.cur_size
            self.off_state, self.off_loss = out[0], out[1]["critic_loss"]
            self.discrete = runner.discrete
            return out

        def alpha(st):
            return None if st.log_alpha is None else float(torch.exp(st.log_alpha.detach()))

        def counted_sample(mu, log_std, eps, act_limit, deterministic=False):
            # the sample an actor's loss is taken through (the only one
            # made with gradients on): its raw log-std against the floor
            if torch.is_grad_enabled() and not deterministic:
                self.pending = (log_std.detach() < D.LOG_STD_MIN).sum(), log_std.numel()
            return sample(mu, log_std, eps, act_limit, deterministic)

        def counted_step_actor(runner, st, loss):
            if self.pending is not None:
                below, n = self.clamped.get(id(st), (0, 0))
                self.clamped[id(st)] = below + self.pending[0], n + self.pending[1]
                self.pending = None
            return step_actor(runner, st, loss)

        def clamped_share(st):
            below, n = self.clamped.get(id(st), (0, 0))
            return float(below) / n if n else None

        def logged(logger, record):
            if self.off_state is not None:      # the learners a record was made after
                st = self.off_state
                self.learners.append(dict(
                    steps=record["steps"], critic_loss=float(self.off_loss),
                    alpha=[alpha(a) for a in st.actors], critic_alpha=alpha(st.critic),
                    log_std_below_min=[clamped_share(a) for a in st.actors]))
                self.clamped = {}
                # in the run's log too, should the run be cut before its record
                print("learners", json.dumps(self.learners[-1]), flush=True)
            return log_episode(logger, record)

        on_policy.compute_gae = checked_gae
        on_policy.OnPolicyRunner.train_iteration = timed(train_iteration, self.iteration_s)
        on_policy.OnPolicyRunner.evaluate = timed(evaluate, self.eval_s)
        Off.collect_block = timed(collect_block, self.collect_s)
        Off.train_block = timed(counted_train_block, self.train_s)
        Off.evaluate = timed(off_evaluate, self.eval_s)
        TrainLogger.log_episode = logged
        D.squashed_gaussian_sample = counted_sample
        Off._step_actor = counted_step_actor
        return self

    def __exit__(self, *exc):
        for owner, name, orig in self.saved:
            setattr(owner, name, orig)


def read_curves(run_dir: str) -> dict:
    """{"eval", "won", "mean_step_reward", "mean_episode_return"}: [(steps,
    value), ...] from a run's progress.txt (the evaluations' return and
    score rate; the training records' mean step reward and mean episode
    return). An off-policy record holds its evaluation too."""
    curves = {"eval": [], "won": [], "mean_step_reward": [], "mean_episode_return": []}
    with open(os.path.join(run_dir, "logs", "progress.txt")) as f:
        for line in f:
            rec = json.loads(line)
            if "eval_return" in rec:
                curves["eval"].append((rec["steps"], rec["eval_return"]))
                if "eval_win_rate" in rec:
                    curves["won"].append((rec["steps"], rec["eval_win_rate"]))
            for key in ("mean_step_reward", "mean_episode_return"):
                if key in rec:
                    curves[key].append((rec["steps"], rec[key]))
    return curves


def write_curves(out_dir: str, name: str, seed: int, curves: dict) -> str:
    """Write each curve of ``curves`` that has points into ``out_dir`` as
    ``<name>_s<seed>_<key>.csv``; returns the stem ``<out_dir>/<name>_s<seed>``."""
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.join(out_dir, f"{name}_s{seed}")
    for key, series in curves.items():
        if series:
            with open(f"{stem}_{key}.csv", "w") as f:
                f.write("".join(f"{s},{v}\n" for s, v in series))
    return stem


def is_off_policy(name: str) -> bool:
    return RUNS[name]["shape"] is None


def budget_of(name: str, tr: dict) -> tuple:
    """(env-steps trained, env-steps an iteration or block) of a run whose
    resolved train section is ``tr``: whole iterations of T x n, or
    blocks of ``train_interval`` x n after a warmup that is not counted."""
    n = tr["n_rollout_threads"]
    step = tr["train_interval"] * n if is_off_policy(name) else tr["episode_length"] * n
    return max(tr["num_env_steps"] // step, 1) * step, step


def run_argv(name: str, seed: int, platform: str, iterations: int, extra: list,
             log_dir: str) -> tuple:
    """(the argv of one run, its resolved train section): the JAX run's
    argv, the seed, the device, the words of ``extra`` and, with
    ``iterations``, a budget of that many."""
    from harl_tpu_torch import train

    argv = [*RUNS[name]["argv"], "--seed", str(seed), "--exp_name", f"parity_s{seed}",
            "--log_dir", log_dir, *(["--platform", "cpu"] if platform == "cpu" else []), *extra]
    tr = train.resolve_args(argv)[1]["train"]
    if iterations:
        tr["num_env_steps"] = iterations * budget_of(name, tr)[1]
        argv += ["--num_env_steps", str(tr["num_env_steps"])]
    return argv, tr


def run_one(name: str, seed: int, platform: str, out_dir: str, log_dir: str,
            iterations: int = 0, extra: tuple = (), concurrent: int = 1,
            ranks: int = 1, cards: int = 1) -> dict:
    """Train one (run, seed) in this process (with ``ranks`` above 1, this
    process's rank of it: ``extra`` then names the process group), write
    its CSVs and JSON into ``out_dir`` (rank 0 only) and return the
    record; raises after writing it if the GAE kernel was not launched
    once an iteration or its in-situ error is out of bound (off-policy:
    if it was launched, or the ring's rows are not the run's)."""
    import torch

    from harl_tpu_torch import train
    from harl_tpu_torch.ops import gae_kernels as K

    if platform != "cpu" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the parity runs need one (or --platform cpu)")
    card = "cpu" if platform == "cpu" else _chip_smoke().card_line()
    argv, tr = run_argv(name, seed, platform, iterations, list(extra), log_dir)
    n = tr["n_rollout_threads"]
    budget = budget_of(name, tr)[0]
    columns = n // ranks     # a rank's envs
    if is_off_policy(name):
        al = train.resolve_args(argv)[1]["algo"]
        expect = dict(launches=0, ring_rows=min(tr["warmup_steps"] // n * n + budget,
                                                al["buffer_size"]))
    else:
        expect = dict(shape=(tr["episode_length"], columns))
    if platform != "cpu":
        torch.cuda.reset_peak_memory_stats()
    launches0 = K.gae.launches
    t0 = time.perf_counter()
    with Instruments(platform) as ins:
        run_dir = train.main(argv)
    wall = time.perf_counter() - t0
    launches = K.gae.launches - launches0
    avail_rows = None
    if is_off_policy(name):   # a block: its collect and its train
        ins.iteration_s = [c + t for c, t in zip(ins.collect_s, ins.train_s)]
        avail_rows = written_avail_rows(ins.off_state.buffer)
        expect["discrete"] = ins.discrete
    iters = len(ins.iteration_s)
    situ = ins.in_situ
    if run_dir is None:
        # a rank other than 0: nothing written, its own kernel checked
        print(f"{name} seed {seed}: a rank of {ranks}, {iters} iterations, gae launches "
              f"{launches}; {situ_text(situ, ins.ring_rows)}", flush=True)
        check_rank(name, seed, platform, launches, iters, situ, ins.ring_rows, expect,
                   avail_rows)
        return {}
    curves = read_curves(run_dir)
    stem = write_curves(out_dir, name, seed, curves)
    spec = RUNS[name]
    values = dict(curves[spec["metric"]])
    rec = dict(
        run=name, seed=seed, argv=argv, card=card, platform=platform, concurrent=concurrent,
        ranks=ranks, cards=cards,
        device=torch.cuda.get_device_name(0) if platform != "cpu" else "cpu",
        env_steps=budget, iterations=iters, wall_s=wall, env_steps_per_s=budget / wall,
        iteration_s=ins.iteration_s, eval_s=ins.eval_s,
        **(dict(collect_s=ins.collect_s, train_s=ins.train_s, learners=ins.learners)
           if is_off_policy(name) else {}),
        peak_cuda_bytes=torch.cuda.max_memory_allocated() if platform != "cpu" else None,
        peak_rss_bytes=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
        gae_launches=launches, gae_launches_per_iteration=launches / max(iters, 1),
        gae_in_situ=ins.in_situ, ring_rows=ins.ring_rows, avail_rows=avail_rows,
        metric=spec["metric"],
        at_record={str(step): value_at(name, values, step) for step, _ in spec["record"]},
        run_dir=run_dir)
    with open(f"{stem}.json", "w") as f:
        json.dump(rec, f, indent=1)
    print(f"{name} seed {seed}: {iters} iterations, {budget} env-steps in {wall:.1f} s "
          f"({budget / wall:.1f} env-steps/s, {concurrent} run(s) at once), evals "
          f"{[round(s, 2) for s in ins.eval_s]} s; gae launches {launches}; "
          f"{situ_text(situ, ins.ring_rows)}; at the record {rec['at_record']} on "
          f"{card_label(rec)}", flush=True)
    check_rank(name, seed, platform, launches, iters, situ, ins.ring_rows, expect, avail_rows)
    return rec


def written_avail_rows(buffer):
    """Of the ring's rows written so far, how many hold an availability row
    with an action available, for each agent's ``available_actions`` and
    then each agent's ``next_available_actions``; None where the ring keeps
    no availability (Box actions). A row never written is all zeros."""
    if buffer.available_actions is None:
        return None
    rows = buffer.cur_size
    return [int((a[:rows].sum(dim=-1) > 0).sum())
            for a in (*buffer.available_actions, *buffer.next_available_actions)]


def situ_text(situ: dict, ring_rows: int) -> str:
    if situ is None:
        return f"replay ring rows {ring_rows}"
    return (f"in situ T={situ['T']}, b={situ['b']}: max |err| {situ['max_abs_err']:.3g} of "
            f"returns up to {situ['max_abs_return']:.3g}, {situ['ms']} ms warm")


def check_rank(name: str, seed: int, platform: str, launches: int, iters: int, situ: dict,
               ring_rows: int, expect: dict, avail_rows: list = None) -> None:
    """Raise unless the GAE kernel ran once an iteration (on a card) and
    its in-situ error at the rank's (T, b), ``expect["shape"]``, is within
    bound; for an off-policy run, unless it never ran, the ring holds
    ``expect["ring_rows"]`` rows and, under discrete actions
    (``expect["discrete"]``), each of those rows holds its availability
    (``avail_rows``, of ``written_avail_rows``; None under Box actions)."""
    if "ring_rows" in expect:
        if launches != expect["launches"] or ring_rows != expect["ring_rows"]:
            raise AssertionError(f"{name} seed {seed}: gae launched {launches} times, the "
                                 f"ring holds {ring_rows} rows; expected {expect}")
        if expect.get("discrete") and (not avail_rows
                                       or any(r != ring_rows for r in avail_rows)):
            raise AssertionError(f"{name} seed {seed}: availability written in {avail_rows} "
                                 f"of the ring's {ring_rows} rows")
        if not expect.get("discrete") and avail_rows is not None:
            raise AssertionError(f"{name} seed {seed}: availability kept under Box actions")
        return
    shape = expect["shape"]
    if platform != "cpu" and launches != iters:
        raise AssertionError(f"{name} seed {seed}: gae launched {launches} times in {iters} "
                             "iterations")
    if situ["max_abs_err"] > GAE_REL_BOUND * situ["max_abs_return"]:
        raise AssertionError(f"{name} seed {seed}: in-situ gae error {situ['max_abs_err']} "
                             f"beyond {GAE_REL_BOUND} of {situ['max_abs_return']}")
    if (situ["T"], situ["b"]) != shape:
        raise AssertionError(f"{name}: gae in situ at T={situ['T']}, b={situ['b']}, "
                             f"expected T={shape[0]}, b={shape[1]}")


def card_label(rec: dict) -> str:
    """The card a record ran on and, over several ranks, how many ranks
    and cards it used (a record without ``ranks`` is one rank on one card)."""
    ranks = rec.get("ranks", 1)
    if ranks == 1:
        return rec["card"]
    if rec.get("platform") == "cpu":
        return f"{ranks} ranks on the CPU"
    return f"{ranks} ranks on {rec['cards']} cards: {rec['card']}"


def load_records(out_dir: str, names) -> dict:
    """{run: [its seeds' JSON records, by seed]} from ``out_dir``."""
    found = {}
    for name in names:
        recs = []
        for path in sorted(Path(out_dir).glob(f"{name}_s*.json")):
            with open(path) as f:
                recs.append(json.load(f))
        if recs:
            found[name] = sorted(recs, key=lambda r: r["seed"])
    return found


def table(out_dir: str, names) -> tuple:
    """(the markdown table of the runs found in ``out_dir``, {run:
    verdict}): a row a run and record point, and a run's verdict "meets"
    only where every point meets, "misses" where a point it reached
    misses, else "cut"."""
    lines = ["| Run | Step | Port, by seed | Median | JAX record | Tolerance | Verdict | "
             "env-steps/s, by seed (runs at once) | Wall s, by seed | GAE launches an "
             "iteration; in-situ max \\|err\\| / largest return | Card |",
             "| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |"]
    verdicts = {}
    for name, recs in load_records(out_dir, names).items():
        spec = RUNS[name]
        seen = []
        for step, record in spec["record"]:
            vals = [r["at_record"].get(str(step)) for r in recs]
            med, word = verdict(spec["metric"], [v for v in vals if v is not None], record)
            seen.append(word)
            by_seed = ", ".join(f"s{r['seed']} {'—' if v is None else f'{v:.4g}'}"
                                for r, v in zip(recs, vals))
            rates = ", ".join(f"{r['env_steps_per_s']:.1f}" for r in recs)
            walls = ", ".join(f"{r['wall_s']:.1f}" for r in recs)
            gae = ", ".join(f"{r['gae_launches_per_iteration']:g}; "
                            + (f"ring rows {r['ring_rows']:,}" if r["gae_in_situ"] is None else
                               f"{r['gae_in_situ']['max_abs_err']:.2g} / "
                               f"{r['gae_in_situ']['max_abs_return']:.3g}") for r in recs)
            cards = "; ".join(sorted({card_label(r) for r in recs}))
            steps = window_steps(name, step)
            where = (f"{step:,}" if len(steps) == 1 else
                     f"{steps[0]:,}–{step:,} (mean of {len(steps)} evaluations)")
            lines.append(
                f"| {name} | {where} | {by_seed} | {'—' if med is None else f'{med:.4g}'} | "
                f"{spec['metric']} {record} ({spec['source']}"
                f"{'; ' + spec['note'] if 'note' in spec else ''}) | "
                f"{tolerance(spec['metric'], record):.3g} | {word} | {rates} "
                f"({max(r['concurrent'] for r in recs)}) | {walls} | {gae} | {cards} |")
        verdicts[name] = ("misses" if "misses" in seen else
                          "cut" if "cut" in seen else "meets")
    return "\n".join(lines), verdicts


def jax_argv(name: str, seed: int, iterations: int, log_dir: str) -> list:
    """The JAX CLI's argv of one seed of ``name``: the record's own, with
    only the seed and, with ``iterations``, the budget changed, its run
    directories under ``log_dir``."""
    argv = list(RUNS[name]["argv"])
    if iterations:
        from harl_tpu_torch import train

        tr = train.resolve_args(argv)[1]["train"]
        argv[argv.index("--num_env_steps") + 1] = str(iterations * budget_of(name, tr)[1])
    return argv + ["--seed", str(seed), "--log_dir", log_dir]


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            return next(line.split(":", 1)[1].strip() for line in f
                        if line.startswith("model name"))
    except (OSError, StopIteration):
        import platform

        return platform.processor() or "unknown"


def jax_record(name: str, seed: int, argv: list, run_root: str, out_dir: str, wall: float,
               concurrent: int) -> dict:
    """Write the curves and the JSON record of one JAX CLI run whose run
    directories are under ``run_root`` into ``out_dir``; returns the record."""
    from importlib.metadata import version

    progress = sorted(Path(run_root).glob("**/logs/progress.txt"))[-1]
    curves = read_curves(str(progress.parent.parent))
    stem = write_curves(out_dir, name, seed, curves)
    spec = RUNS[name]
    values = dict(curves[spec["metric"]])
    # the run directories lie outside the checkout: their place is not recorded
    argv = [a if a != run_root else "<log_dir>" for a in argv]
    rec = dict(run=name, seed=seed, package="harl_tpu", command="python -m harl_tpu.train",
               argv=argv, platform="cpu", jax_version=version("jax"), device=cpu_model(),
               cores=os.cpu_count(), concurrent=concurrent, wall_s=wall,
               env_steps=max(s for s, _ in curves[spec["metric"]]), metric=spec["metric"],
               at_record={str(step): value_at(name, values, step)
                          for step, _ in spec["record"]})
    with open(f"{stem}.json", "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def run_jax(pairs: list, args) -> list:
    """Train each (run, seed) with the JAX package's CLI on the CPU
    (``JAX_PLATFORMS=cpu``), ``args.jobs`` at once, each in a process with
    a compile cache of its own under ``args.log_dir``; as each ends, write
    its curves and record (the most JAX runs alive at once during it,
    ``concurrent``) into ``args.out``. Returns the pairs that failed."""
    os.makedirs(args.log_dir, exist_ok=True)
    pending, running, failed = list(pairs), [], []
    while pending or running:
        while pending and len(running) < args.jobs:
            name, seed = pending.pop(0)
            root = os.path.join(os.path.abspath(args.log_dir), f"{name}_s{seed}")
            argv = jax_argv(name, seed, args.iterations, root)
            env = dict(os.environ, JAX_PLATFORMS="cpu",
                       JAX_COMPILATION_CACHE_DIR=os.path.join(root, "jax_cache"))
            log = open(os.path.join(args.log_dir, f"{name}_s{seed}_jax.log"), "w")
            proc = subprocess.Popen([sys.executable, "-m", "harl_tpu.train", *argv], cwd=REPO,
                                    stdout=log, stderr=subprocess.STDOUT, env=env)
            running.append(dict(proc=proc, log=log, name=name, seed=seed, argv=argv, root=root,
                                t0=time.perf_counter(), concurrent=0))
            print(f"started the JAX run {name} seed {seed}: {' '.join(argv)}", flush=True)
        for item in running:
            item["concurrent"] = max(item["concurrent"], len(running))
        time.sleep(1.0)
        for item in list(running):
            code = item["proc"].poll()
            if code is None:
                continue
            running.remove(item)
            item["log"].close()
            name, seed = item["name"], item["seed"]
            if code != 0:
                with open(item["log"].name) as f:
                    print(f"{name} seed {seed} (JAX) exited {code}:\n"
                          + "\n".join(f.read().splitlines()[-30:]), flush=True)
                failed.append((name, seed))
                continue
            rec = jax_record(name, seed, item["argv"], item["root"], args.out,
                             time.perf_counter() - item["t0"], item["concurrent"])
            print(f"{name} seed {seed} (JAX, CPU): {rec['wall_s']:.1f} s, "
                  f"{rec['concurrent']} at once; at the record {rec['at_record']}", flush=True)
    return failed


# a second reading of a record (``--spread``), beside its verdict: the JAX
# package's own seeds on the CPU (``--jax``) with its TPU record, against
# the port's seeds; the curves of earlier physics listed apart, outside it
SPREAD = {
    "halfcheetah_6x1_hasac": dict(
        jax="validation_torch/jax_cpu_spread", port="validation_torch/repaired_physics",
        port_label="the port, repaired physics (PR 17)",
        apart=("PR 15's physics", ("validation_torch", "validation_torch/hasac_spread"))),
}
# the least two-sided Mann-Whitney U p-value of the port's seeds against JAX's
SPREAD_P = 0.05


def seed_curves(dirs, name: str, metric: str) -> dict:
    """{seed: {step: value}} from the ``<name>_s<seed>_<metric>.csv`` files
    of ``dirs``, relative to the repository's root (a seed found in two
    directories: the first)."""
    found = {}
    for d in dirs:
        for path in sorted((REPO / d).glob(f"{name}_s*_{metric}.csv")):
            seed = path.name[len(name) + 2:-len(metric) - 5]
            if seed.isdigit() and int(seed) not in found:
                with open(path) as f:
                    found[int(seed)] = {int(float(s)): float(v) for s, v in
                                        (line.split(",") for line in f if line.strip())}
    return dict(sorted(found.items()))


def within_spread(port: list, jax: list) -> tuple:
    """(the p-value, the reading) of one step: "within" JAX's spread when
    the median of ``port`` lies in the range of ``jax`` and the two-sided
    Mann-Whitney U test of the two gives p of at least ``SPREAD_P``, else
    "outside"; "not measured" where a side is empty."""
    if not port or not jax:
        return None, "not measured"
    from scipy.stats import mannwhitneyu

    med = statistics.median(port)
    p = float(mannwhitneyu(port, jax, alternative="two-sided").pvalue)
    return p, "within" if min(jax) <= med <= max(jax) and p >= SPREAD_P else "outside"


def _summary(vals: list) -> str:
    if not vals:
        return "—"
    return (f"median {statistics.median(vals):.0f} [{min(vals):.0f}, {max(vals):.0f}], "
            f"n={len(vals)}")


def _group(values: dict) -> str:
    """Each seed's value, then the median, range and count."""
    if not values:
        return "—"
    return (", ".join(f"s{s} {v:.0f}" for s, v in values.items()) + "; "
            + _summary(list(values.values())))


def spread_table(name: str, spread: dict = None) -> tuple:
    """(the markdown table, {step: reading}, whether every step measured on
    both sides is within JAX's spread) of ``name``'s record steps. The JAX
    values at a step are its CPU seeds' and the TPU record's; a step is
    measured on JAX's side where a CPU seed reached it."""
    spec, sp = RUNS[name], spread or SPREAD[name]
    metric = spec["metric"]
    jax = seed_curves([sp["jax"]], name, metric)
    port = seed_curves([sp["port"]], name, metric)
    apart_label, apart_dirs = sp["apart"]
    apart = seed_curves(apart_dirs, name, metric)
    lines = [f"| Step | JAX, CPU seeds (`--jax`) | JAX record (TPU, one seed) | JAX, all | "
             f"{sp['port_label']} | Mann–Whitney p | Reading | {apart_label}, apart |",
             "| --- | --- | --- | --- | --- | --- | --- | --- |"]
    readings = {}
    for step, record in spec["record"]:
        at = {}
        for label, curves in (("jax", jax), ("port", port), ("apart", apart)):
            at[label] = {s: v for s, v in ((s, value_at(name, c, step)) for s, c in curves.items())
                         if v is not None}
        if not at["jax"] and not at["port"]:
            continue
        jax_all = [*at["jax"].values(), record] if at["jax"] else []
        p, word = within_spread(list(at["port"].values()), jax_all)
        readings[step] = word
        lines.append(
            f"| {step:,} | {_group(at['jax'])} | {record} | {_summary(jax_all)} | "
            f"{_group(at['port'])} | {'—' if p is None else f'{p:.3g}'} | {word} | "
            f"{_group(at['apart'])} |")
    measured = [w for w in readings.values() if w != "not measured"]
    return "\n".join(lines), readings, bool(measured) and all(w == "within" for w in measured)


def run_children(pairs: list, args, extra: list) -> list:
    """Run each (run, seed) as child processes, one a rank (``args.ranks``),
    ``args.jobs`` runs at once, a rank's output in
    ``<log_dir>/<run>_s<seed>.log`` (rank k > 0: ``<run>_s<seed>_rank<k>.log``);
    returns the pairs that failed. A rank that fails stops its run's
    others."""
    from harl_tpu_torch.parallel.launch import free_port

    os.makedirs(args.log_dir, exist_ok=True)
    pending, running, failed = list(pairs), [], []
    while pending or running:
        while pending and len(running) < args.jobs:
            name, seed = pending.pop(0)
            coordinator, group = f"localhost:{free_port()}", []
            for k in range(args.ranks):
                log = open(os.path.join(args.log_dir, f"{name}_s{seed}"
                                        + (f"_rank{k}" if k else "") + ".log"), "w")
                cmd = [sys.executable, str(Path(__file__).resolve()), "--child", "--runs", name,
                       "--seeds", str(seed), "--platform", args.platform, "--out", args.out,
                       "--log_dir", args.log_dir, "--iterations", str(args.iterations),
                       "--jobs", str(min(args.jobs, len(pairs))), "--ranks", str(args.ranks),
                       "--cards", str(args.cards), "--", *extra]
                env = dict(os.environ)
                if args.ranks > 1:
                    cmd += ["--num_processes", str(args.ranks), "--coordinator", coordinator,
                            "--process_id", str(k), "--n_devices", "1"]
                    if args.cards:
                        env["CUDA_VISIBLE_DEVICES"] = str(k % args.cards)
                group.append((subprocess.Popen(cmd, cwd=REPO, stdout=log,
                                               stderr=subprocess.STDOUT, env=env), log))
            running.append((group, name, seed))
            print(f"started {name} seed {seed}"
                  + (f" on {args.ranks} ranks" if args.ranks > 1 else ""), flush=True)
        time.sleep(1.0)
        for item in list(running):
            group, name, seed = item
            codes = [proc.poll() for proc, _ in group]
            if any(c not in (None, 0) for c in codes):
                for proc, _ in group:
                    if proc.poll() is None:
                        proc.kill()
                codes = [proc.wait() for proc, _ in group]
            if None in codes:
                continue
            running.remove(item)
            tails = []
            for (proc, log), code in zip(group, codes):
                log.close()
                with open(log.name) as f:
                    tails += f.read().splitlines()[-1 if code == 0 else -30:]
            code = max(codes, key=abs)
            print(f"{name} seed {seed} exited {code}: " + "\n".join(tails), flush=True)
            if code != 0:
                failed.append((name, seed))
    return failed


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    extra = []
    if "--" in argv:
        extra = argv[argv.index("--") + 1:]
        argv = argv[:argv.index("--")]
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", default=",".join(RUNS))
    ap.add_argument("--seeds", default="1,2,3")
    ap.add_argument("--jobs", type=int, default=1, help="runs at once")
    ap.add_argument("--ranks", type=int, default=1,
                    help="data-parallel ranks a run, one child process a rank")
    ap.add_argument("--cards", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--iterations", type=int, default=0, help="cut each run to N iterations")
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="validation_torch")
    ap.add_argument("--log_dir", default="results/parity")
    ap.add_argument("--table", action="store_true", help="print the table of --out only")
    ap.add_argument("--child", action="store_true", help="one (run, seed) here (internal)")
    ap.add_argument("--jax", action="store_true",
                    help="train the JAX package's runs on the CPU instead of the port's")
    ap.add_argument("--spread", choices=tuple(SPREAD),
                    help="print the record's spread table of the committed curves only")
    args = ap.parse_args(argv)
    if args.spread:
        text, readings, within = spread_table(args.spread)
        print(text)
        print(json.dumps({"spread": {str(s): w for s, w in readings.items()},
                          "within_at_every_measured_step": within}))
        return 0
    names = args.runs.split(",")
    unknown = [n for n in names if n not in RUNS]
    if unknown:
        ap.error(f"unknown runs {unknown}: {list(RUNS)}")
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.jax:
        if extra:
            ap.error("--jax runs the record's own argv: no words after --")
        failed = run_jax([(n, s) for n in names for s in seeds], args)
        print(json.dumps({"failed": failed}))
        return 1 if failed else 0
    if args.child:
        run_one(names[0], seeds[0], args.platform, args.out, args.log_dir, args.iterations,
                extra, args.jobs, args.ranks, min(args.ranks, args.cards))
        return 0
    failed = []
    if not args.table:
        import torch

        if args.platform != "cpu":
            if not torch.cuda.is_available():
                print("no CUDA device: the parity runs need one (or --platform cpu)",
                      file=sys.stderr)
                return 1
            from harl_tpu_torch.ops import _build

            _build.build("gae")   # once, before the children load it
            print(_chip_smoke().card_line(), flush=True)
            args.cards = torch.cuda.device_count()
        failed = run_children([(n, s) for n in names for s in seeds], args, extra)
    text, verdicts = table(args.out, names)
    print(text)
    print(json.dumps({"verdicts": verdicts, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
