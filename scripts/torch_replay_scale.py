#!/usr/bin/env python3
"""Replay rings at the tuned configs' full scale: each tuned SMACLite FP
HASAC config (``buffer_size`` 1,000,000) trained through
``harl_tpu_torch.train.main`` with its own argv for its whole warmup and
one block, with the evaluation at that block, and the largest two resumed
from their checkpoint in a fresh process.

    python scripts/torch_replay_scale.py [--maps M,...] [--resume M,...]
        [--platform cpu] [--out validation_torch/replay_scale]
        [--log_dir results/replay_scale] [-- EXTRA ARGV]

Run it from the root of the repository. Each run is a child process of its
own (``--load_config tuned_configs/smaclite/<map>/hasac/config.json
--exp_name replay_scale``, ``--num_env_steps`` cut to one block of
``train_interval`` x ``n_rollout_threads``); the words after ``--`` are
appended to every run's argv (a small ``--buffer_size`` and narrow widths
on the CPU). Before the ring is allocated the child prints its predicted
bytes (``OffPolicyRunner.ring_nbytes``) and refuses with ``ValueError``,
naming both sizes, where the card's free memory is less. It records, in
``--out/<map>.json``: the predicted and allocated bytes of the ring, peak
``torch.cuda.max_memory_allocated`` and ``max_memory_reserved``, the peak
RSS, the warmup's, the collect and train block's and the evaluation's
seconds and env-steps/s, one ``end_flag`` call's warm time, the
checkpoint's bytes on disk and write seconds, and the card's name and
power limit (``nvidia-smi``).

A map of ``--resume`` (MMM2 and 10m_vs_11m by default) then trains one more
block in a fresh process with ``--model_dir <its run directory>``: the
runner warms up again after the restore, as the JAX runner does. That
child records the restore's seconds and its peak device memory (the peak
reset just before it), and requires the ring's tensors to keep their
storage, the peak to stay below the ring plus 4 GiB (a restore that
loaded the file onto the card beside the live ring peaked at twice the
ring), and every column of the restored ring to equal the file's bytes,
compared in chunks of at most 1 GiB so the card never holds two rings.
Once the ring is verified the child deletes the checkpoint it restored,
so that the disk holds one checkpoint of a map at a time: the parent
checks at the start that the disk has room for the largest (its ring plus
256 MiB), and exits non-zero naming both numbers if not, and deletes
each map's checkpoints when the map is done. The eight maps write ~390 GB
of checkpoints in all; where a host caps what a process writes to its
disk (45 GiB a run on the H100 host the rings were measured on), point
``--log_dir`` at a memory-backed directory (``/dev/shm``) with room for
the largest. The script exits non-zero if a child failed.
"""
from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import os
import resource
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
MAPS = ("5m_vs_6m", "6h_vs_8z", "8m_vs_9m", "3s5z", "3s5z_vs_3s6z", "corridor", "10m_vs_11m",
        "MMM2")
RESUMED = ("10m_vs_11m", "MMM2")
GIB = 2 ** 30
# a checkpoint beside its ring: networks, optimizers, the carry
CHECKPOINT_EXTRA = 256 * 2 ** 20
END_FLAG_REPS = 20


def config_path(map_name: str) -> str:
    return f"tuned_configs/smaclite/{map_name}/hasac/config.json"


@functools.cache
def _chip_smoke():
    """``chip_smoke.py`` as a module: its card line, and the restore's
    measurement and checks, which its phase 23 shares."""
    spec = importlib.util.spec_from_file_location("chip_smoke_replay", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def run_argv(map_name: str, platform: str, log_dir: str, extra: list,
             model_dir: str = None) -> tuple:
    """(the argv of one run, its resolved configs): the tuned config's own
    argv, the device, the words of ``extra``, a budget of one block and
    the checkpoint to resume from."""
    from harl_tpu_torch import train

    argv = ["--load_config", config_path(map_name), "--exp_name", "replay_scale",
            "--log_dir", log_dir, *(["--platform", "cpu"] if platform == "cpu" else []), *extra]
    resolved = train.resolve_args(argv)
    tr = resolved[1]["train"]
    argv += ["--num_env_steps", str(tr["train_interval"] * tr["n_rollout_threads"])]
    if model_dir:
        argv += ["--model_dir", model_dir]
    return argv, train.resolve_args(argv)


def planned_ring(map_name: str, extra: list) -> int:
    """The ring's bytes of a map's run, from its runner built on the CPU
    (no ring allocated)."""
    from harl_tpu_torch.runners.off_policy import OffPolicyRunner

    _, (args, algo_args, env_args) = run_argv(map_name, "cpu", "unused", extra)
    return OffPolicyRunner(args, algo_args, env_args, device="cpu").ring_nbytes()


class Instruments:
    """For the duration of a ``with``, on every ``OffPolicyRunner``: the
    ring's predicted bytes and the card-memory refusal before
    ``init_state`` allocates it, the allocated bytes after; the warmup's,
    each collect and train block's and each evaluation's seconds; one
    ``end_flag``'s warm time at the first sample; each checkpoint's write
    seconds and bytes on disk; and with ``resume``, the restore
    (``chip_smoke.py``'s ``measured_restore``), after which the restored
    checkpoint is deleted."""

    def __init__(self, resume: bool = False):
        self.resume = resume
        self.rec = dict(warmup_s=None, collect_s=[], train_s=[], eval_s=[], saves=[])

    def __enter__(self):
        import torch

        from harl_tpu_torch.buffers import off_policy as buffers
        from harl_tpu_torch.runners.off_policy import OffPolicyRunner as R
        from harl_tpu_torch.utils import checkpoint

        rec = self.rec
        sync = _chip_smoke().sync
        self.saved = [(R, k, getattr(R, k)) for k in
                      ("init_state", "warmup_block", "collect_block", "train_block",
                       "evaluate", "restore")]
        self.saved += [(checkpoint, "save_state", checkpoint.save_state),
                       (buffers.ReplayBuffer, "end_flag", buffers.ReplayBuffer.end_flag)]
        orig = {k: fn for _, k, fn in self.saved}

        def init_state(runner, seed):
            need = runner.ring_nbytes()
            rec.update(predicted_bytes=need, predicted_gib=need / GIB,
                       n_rollout_threads=runner.n_rollout_threads,
                       train_interval=runner.train_interval, warmup_steps=runner.warmup_steps,
                       batch_size=runner.batch_size, n_step=runner.n_step,
                       buffer_size=runner.buffer_size)
            print(f"replay ring: {need} bytes ({need / GIB:.3f} GiB) predicted", flush=True)
            cuda = runner.device.type == "cuda"
            if cuda:
                buffers.require_room(need, torch.cuda.mem_get_info(runner.device)[0],
                                     "the card's free memory for the replay ring")
                before = torch.cuda.memory_allocated(runner.device)
            state = orig["init_state"](runner, seed)
            rec.update(allocated_bytes=state.buffer.nbytes,
                       allocated_gib=state.buffer.nbytes / GIB,
                       init_allocated_bytes=(torch.cuda.memory_allocated(runner.device)
                                             - before) if cuda else None)
            if state.buffer.nbytes != need:
                raise AssertionError(f"the ring holds {state.buffer.nbytes} bytes, "
                                     f"{need} predicted")
            return state

        def timed(name, into):
            def wrapped(runner, *args):
                sync(runner.device)
                t0 = time.perf_counter()
                out = orig[name](runner, *args)
                sync(runner.device)
                into(time.perf_counter() - t0)
                return out
            return wrapped

        def end_flag(buf, n_threads):
            if "end_flag_ms" not in rec:
                device = buf.dones.device
                orig["end_flag"](buf, n_threads)
                sync(device)
                t0 = time.perf_counter()
                for _ in range(END_FLAG_REPS):
                    orig["end_flag"](buf, n_threads)
                sync(device)
                rec["end_flag_ms"] = (time.perf_counter() - t0) / END_FLAG_REPS * 1e3
                rec["end_flag_bytes"] = buf.dones.nbytes
            return orig["end_flag"](buf, n_threads)

        def save_state(save_dir, payload, step=0):
            t0 = time.perf_counter()
            path = orig["save_state"](save_dir, payload, step)
            rec["saves"].append(dict(path=path, write_s=time.perf_counter() - t0,
                                     bytes=os.path.getsize(
                                         os.path.join(path, checkpoint.STATE_FILE))))
            return path

        def restore(runner, state, model_dir):
            smoke = _chip_smoke()
            state, r = smoke.measured_restore(lambda s, d: orig["restore"](runner, s, d),
                                              runner, state, model_dir)
            rec["restore"] = r
            smoke.check_restore(r, "resume")
            # one checkpoint of the map on disk at a time: the resumed run
            # writes its own at its end
            shutil.rmtree(r["path"])
            return state

        R.init_state = init_state
        R.warmup_block = timed("warmup_block", lambda s: rec.update(warmup_s=s))
        R.collect_block = timed("collect_block", rec["collect_s"].append)
        R.train_block = timed("train_block", rec["train_s"].append)
        R.evaluate = timed("evaluate", rec["eval_s"].append)
        checkpoint.save_state = save_state
        buffers.ReplayBuffer.end_flag = end_flag
        if self.resume:
            R.restore = restore
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)


def run_map(map_name: str, platform: str, out_dir: str, log_dir: str, extra: list,
            model_dir: str = None) -> dict:
    """Train one map's run in this process (resumed from ``model_dir``
    where given) and write or extend ``out_dir/<map>.json``."""
    import torch

    from harl_tpu_torch import train

    if platform != "cpu" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the runs need one (or --platform cpu)")
    card = "cpu" if platform == "cpu" else _chip_smoke().card_line()
    argv, _ = run_argv(map_name, platform, log_dir, extra, model_dir)
    if platform != "cpu":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with Instruments(resume=model_dir is not None) as ins:
        run_dir = train.main(argv)
    r = ins.rec
    r.update(map=map_name, argv=argv, card=card, run_dir=run_dir,
             wall_s=time.perf_counter() - t0,
             peak_cuda_allocated_bytes=(torch.cuda.max_memory_allocated()
                                        if platform != "cpu" else None),
             peak_cuda_reserved_bytes=(torch.cuda.max_memory_reserved()
                                       if platform != "cpu" else None),
             peak_rss_bytes=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)
    n = r["n_rollout_threads"]
    warm_steps = r["warmup_steps"] // n * n
    block_steps = r["train_interval"] * n
    r["warmup_env_steps_per_s"] = warm_steps / r["warmup_s"]
    r["block_s"] = r["collect_s"][0] + r["train_s"][0]
    r["block_env_steps_per_s"] = block_steps / r["block_s"]
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{map_name}.json")
    if model_dir is None:
        out = r
    else:
        with open(path) as f:
            out = json.load(f)
        out["resume"] = r
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    save = r["saves"][-1]
    print(f"{map_name}{' resumed' if model_dir else ''}: ring {r['predicted_gib']:.3f} GiB "
          f"predicted, {r['allocated_gib']:.3f} allocated; warmup {warm_steps} env-steps in "
          f"{r['warmup_s']:.2f} s ({r['warmup_env_steps_per_s']:.1f}/s), block "
          f"{r['collect_s'][0]:.3f} + {r['train_s'][0]:.3f} s "
          f"({r['block_env_steps_per_s']:.1f} env-steps/s), eval "
          f"{[round(s, 2) for s in r['eval_s']]} s, end_flag {r['end_flag_ms']:.3f} ms; "
          f"checkpoint {save['bytes']} bytes in {save['write_s']:.2f} s; peak "
          f"{r['peak_cuda_allocated_bytes']} allocated, {r['peak_cuda_reserved_bytes']} "
          f"reserved, RSS {r['peak_rss_bytes']} on {card}", flush=True)
    if "restore" in r:
        x = r["restore"]
        print(f"{map_name} restore: {x['restore_s']:.2f} s, peak {x['peak_bytes']} bytes on "
              f"the card ({x['peak_over_before_bytes']} over the {x['allocated_before_bytes']} "
              f"before it) for a ring of {x['ring_bytes']}; storage kept "
              f"{x['storage_kept']}, ring equals the file {x['ring_equals_file']} "
              f"({x['compare_s']:.2f} s)", flush=True)
    return out


def child(args_list: list, log: str) -> int:
    with open(log, "w") as f:
        return subprocess.run(args_list, cwd=REPO, stdout=f, stderr=subprocess.STDOUT).returncode


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    extra = []
    if "--" in argv:
        extra = argv[argv.index("--") + 1:]
        argv = argv[:argv.index("--")]
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--maps", default=",".join(MAPS))
    ap.add_argument("--resume", default=",".join(RESUMED),
                    help="maps resumed from their checkpoint ('' for none)")
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="validation_torch/replay_scale")
    ap.add_argument("--log_dir", default="results/replay_scale")
    ap.add_argument("--child", default=None, help="one map here (internal)")
    ap.add_argument("--model_dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        run_map(args.child, args.platform, args.out, args.log_dir, extra, args.model_dir)
        return 0
    maps = args.maps.split(",")
    resumed = [m for m in args.resume.split(",") if m]
    unknown = [m for m in maps + resumed if m not in MAPS]
    if unknown:
        ap.error(f"unknown maps {unknown}: {list(MAPS)}")
    if args.platform != "cpu":
        import torch

        if not torch.cuda.is_available():
            print("no CUDA device: the runs need one (or --platform cpu)", file=sys.stderr)
            return 1
        print(_chip_smoke().card_line(), flush=True)
    from harl_tpu_torch.buffers.off_policy import require_room

    os.makedirs(args.log_dir, exist_ok=True)
    rings = {m: planned_ring(m, extra) for m in maps}
    need = max(rings.values()) + CHECKPOINT_EXTRA
    free = shutil.disk_usage(args.log_dir).free
    print(f"disk: {free} bytes free under {args.log_dir}, {need} needed (the largest ring, "
          f"{max(rings, key=rings.get)}'s, plus {CHECKPOINT_EXTRA})", flush=True)
    try:
        require_room(need, free, f"the disk under {args.log_dir} for one checkpoint")
    except ValueError as e:
        print(e, file=sys.stderr)
        return 1
    failed = []
    base = [sys.executable, str(Path(__file__).resolve()), "--platform", args.platform,
            "--out", args.out, "--log_dir", args.log_dir]
    for m in maps:
        code = child(base + ["--child", m, "--", *extra],
                     os.path.join(args.log_dir, f"{m}.log"))
        rec_path = os.path.join(args.out, f"{m}.json")
        if code == 0 and m in resumed:
            with open(rec_path) as f:
                run_dir = json.load(f)["run_dir"]
            code = child(base + ["--child", m, "--model_dir", run_dir, "--", *extra],
                         os.path.join(args.log_dir, f"{m}_resume.log"))
        for log in (f"{m}.log", f"{m}_resume.log"):
            path = os.path.join(args.log_dir, log)
            if os.path.exists(path):
                with open(path) as f:
                    lines = f.read().splitlines()
                print("\n".join(lines[-2 if code == 0 else -40:]), flush=True)
        if code != 0:
            failed.append(m)
        # the map's checkpoints: the next map needs the disk
        if os.path.exists(rec_path):
            with open(rec_path) as f:
                rec = json.load(f)
            for r in (rec, rec.get("resume") or {}):
                if r.get("run_dir"):
                    shutil.rmtree(os.path.join(r["run_dir"], "models"), ignore_errors=True)
    print(json.dumps({"maps": maps, "resumed": resumed, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
