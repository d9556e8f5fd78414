"""Port: data parallelism over several ranks as ``scripts/torch_multicard.py``
runs it, on gloo CPU ranks.

The JAX package's ``dryrun_multichip`` (``__graft_entry__.py:81-168``) runs
its four program shapes (HAPPO MLP, HAPPO FP GRU, HASAC blocks, MAPPO
``share_param``) one step each over a data-parallel mesh. Here the script's
leg 1 runs them on four spawned gloo ranks at B=8 and holds each against
the one-rank run of this process as phase 19 of ``chip_smoke.py`` does:
replicas bitwise equal, first-step gradients at rtol 1e-5, atol 1e-6 and
on-policy parameters within ``DP_PARAM_ATOL`` of the one-rank update of the
ranks' own rows, gathered inserts bitwise. The script runs end to end on
two CPU ranks at tiny widths, and refuses more cards than it sees.
"""
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke as smoke
from harl_tpu_torch import train
from harl_tpu_torch.parallel.launch import spawn_ranks
from scripts import torch_multicard as multicard

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
SHAPES = ("happo_mlp", "happo_fp_gru", "hasac", "mappo_share_param")


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The four shapes at B=8: the one-rank runs here, one spawn of four
    gloo ranks running every shape."""
    workloads = multicard.dryrun_workloads(2 * WORLD)
    states, ref = smoke.dp_reference("cpu", str(tmp_path_factory.mktemp("dryrun")), workloads,
                                     "cpu")
    ranks = spawn_ranks(smoke.dp_rank, WORLD, ("cpu", None, states, workloads), timeout_s=300)
    return workloads, states, ref, ranks


@pytest.mark.parametrize("shape", SHAPES)
def test_four_ranks_run_the_dryrun_shape_as_one_rank(four_ranks, shape):
    workloads, states, ref, ranks = four_ranks
    label = f"dryrun_{shape}"
    for res in ranks:
        for st in res[label]["steps"]:
            assert st["mismatch"] == (0, 0.0)       # replicas bitwise equal
            assert all(math.isfinite(v) for v in st["metrics"].values())
    loss = "critic_loss" if shape == "hasac" else "value_loss"
    assert loss in ranks[0][label]["steps"][-1]["metrics"]
    # first-step gradients (and on-policy parameters) against the one-rank
    # update of the ranks' rows, inserts bitwise: raises where they differ
    _, _, rates = smoke.dp_check_ranks("cpu", ranks, {label: states[label]}, ref,
                                       {label: workloads[label]}, "cpu", "test",
                                       "4 gloo CPU ranks")
    assert len(rates[label]["seconds"]) == WORLD


def test_script_end_to_end_on_cpu_ranks(tmp_path):
    """Legs 3 and 4 on two gloo CPU ranks at tiny widths: every row of the
    weak-scaling table, its rates and efficiencies recomputed from each
    rank's walls, the all-reduce latencies at W=2 and the last line (legs
    1 and 2 run through the machinery of the test above)."""
    out = subprocess.run(
        [sys.executable, "scripts/torch_multicard.py", "--platform", "cpu", "--world", "2",
         "--legs", "3,4", "--out", str(tmp_path)], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    full = json.loads((tmp_path / "multicard.json").read_text())
    rows = full["scaling"]["rows"]
    labels = ("halfcheetah", "smaclite_fp", "hasac")
    assert sorted((r["workload"], r["world"]) for r in rows) == sorted(
        (label, w) for label in labels for w in (1, 2))
    per_rank = {"halfcheetah": 2 * 8, "smaclite_fp": 2 * 10, "hasac": 2 * 4}
    for r in rows:
        assert r["env_steps_a_rank_a_step"] == per_rank[r["workload"]]
        assert len(r["walls_by_rank"]) == r["world"]
        assert all(len(w) == r["timed_steps"] == 2 for w in r["walls_by_rank"])
        rate = (r["world"] * r["env_steps_a_rank_a_step"] * r["timed_steps"]
                / max(sum(w) for w in r["walls_by_rank"]))
        assert r["env_steps_per_s"] == pytest.approx(rate, rel=1e-12)
        base = next(b for b in rows if b["workload"] == r["workload"] and b["world"] == 1)
        assert r["efficiency"] == pytest.approx(rate / (r["world"] * base["env_steps_per_s"]),
                                                rel=1e-12)
        assert r["allreduces_a_step"] > 0
        assert f"| {r['workload']} | {r['world']} | split ({r['threads']}) | " \
               f"{r['env_steps_per_s']:.1f} | {r['efficiency']:.3f} |" in out.stdout
    latency = full["scaling"]["allreduce"]["2"]
    assert len(latency) == 2 and latency[0].keys() == {
        "one", "halfcheetah_actor_64x64", "hasac_critic_256x256"}
    assert latency[0]["halfcheetah_actor_64x64"]["elements"] > 1000
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert [(w["workload"], w["world"]) for w in last["weak"]] == \
        [(r["workload"], r["world"]) for r in rows]


def test_script_refuses_more_cards_than_it_sees(tmp_path):
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match=f"{n + 1} cards asked for, {n} visible"):
        multicard.main(["--world", str(n + 1), "--out", str(tmp_path)])
    assert not (tmp_path / "multicard.json").exists()


def test_device_flags_apply_over_a_saved_config():
    """The tuned on-policy configs name only ``platform`` and ``n_devices``
    in their device section; the two-host flags still take effect."""
    argv = ["--load_config",
            str(ROOT / "tuned_configs/mamujoco_jax/HalfCheetah-v2-6x1/happo/config.json"),
            "--num_processes", "2", "--coordinator", "localhost:29500", "--process_id", "1",
            "--n_devices", "2"]
    _, algo_args, _ = train.resolve_args(argv)
    assert algo_args["device"] == {"platform": None, "n_devices": 2, "num_processes": 2,
                                   "coordinator": "localhost:29500", "process_id": 1}
    _, algo_args, _ = train.resolve_args(argv[:2])
    assert algo_args["device"] == {"platform": None, "n_devices": None}
