"""``scripts/torch_learning_parity.py`` on the CPU: each run of its table
resolves to the very experiment of the JAX record (configs and lr
schedules equal to the JAX CLI's), its records equal the committed JAX
curves, the meets/misses rule (windowed for the MPE runs), and the script end to
end at a tiny size, the off-policy HASAC and HAD3QN runs too."""
import argparse
import copy
import importlib.util
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from harl_tpu import train as jtrain
from harl_tpu.algos import common as jcommon
from harl_tpu.runners.off_policy import OffPolicyRunner as JOffRunner
from harl_tpu.runners.on_policy import OnPolicyRunner as JRunner
from harl_tpu.utils import config_tools as jconfig
from harl_tpu_torch import train
from harl_tpu_torch.runners.off_policy import OffPolicyRunner
from harl_tpu_torch.runners.on_policy import OnPolicyRunner

ROOT = Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "scripts" / "torch_learning_parity.py"
_spec = importlib.util.spec_from_file_location("torch_learning_parity", SCRIPT)
parity = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(parity)

# tiny widths for the CPU: one epoch, 4 envs x 20 steps, a short eval
TINY = ["--n_rollout_threads", "4", "--episode_length", "20", "--hidden_sizes", "[8, 8]",
        "--n_eval_rollout_threads", "2", "--eval_episodes", "2", "--episode_limit", "30",
        "--ppo_epoch", "1", "--critic_epoch", "1"]
# the off-policy run's: 2 envs, a warmup of 40 steps, blocks of 10 steps, a
# record every 2 blocks, a ring of 70 rows that the third block fills
TINY_OFF = ["--n_rollout_threads", "2", "--warmup_steps", "40", "--train_interval", "10",
            "--buffer_size", "70", "--batch_size", "16", "--hidden_sizes", "[8, 8]",
            "--n_eval_rollout_threads", "2", "--eval_episodes", "2", "--episode_limit", "30",
            "--eval_interval", "20"]
ON_POLICY_RUNS = [name for name in parity.RUNS if not parity.is_off_policy(name)]
OFF_POLICY_RUNS = [name for name in parity.RUNS if parity.is_off_policy(name)]


def jax_resolve(argv):
    """(main args, algo args, env args) as ``harl_tpu/train.py:34-63``
    resolves a command line."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--algo", default="happo")
    parser.add_argument("--env", default="pettingzoo_mpe")
    parser.add_argument("--exp_name", default="installtest")
    parser.add_argument("--load_config", default="")
    args, unparsed = parser.parse_known_args(argv)
    args = vars(args)
    if args["load_config"]:
        saved_main, algo_args, env_args = jconfig.load_config(args["load_config"])
        args["algo"] = saved_main.get("algo", args["algo"])
        args["env"] = saved_main.get("env", args["env"])
    else:
        algo_args, env_args = jconfig.get_defaults_yaml_args(args["algo"], args["env"])
    jconfig.update_args(jtrain._parse_unknown(unparsed), algo_args, env_args)
    return args, algo_args, env_args


def _argv(name, seed=2):
    """The script's argv of a run, with the config paths from the root."""
    argv = [str(ROOT / a) if a.startswith("tuned_configs/") else a
            for a in parity.RUNS[name]["argv"]]
    return argv + ["--seed", str(seed), "--exp_name", f"parity_s{seed}"]


@pytest.mark.parametrize("name", list(parity.RUNS))
def test_runs_resolve_to_the_jax_experiment(name):
    """(a) The port's CLI resolves each run's argv to the configs the JAX
    CLI resolves; the seed is the one asked for, and the widths and
    budget are the record's."""
    got = train.resolve_args(_argv(name))
    want = jax_resolve(_argv(name))
    assert got == want
    # the JAX commands' own --exp_name names the log directory only
    for exp_name in ("val_r3", "parity_r2"):
        other = train.resolve_args(_argv(name) + ["--exp_name", exp_name])
        assert other[0] == dict(got[0], exp_name=exp_name) and other[1:] == got[1:]
    tr = got[1]["train"]
    assert got[1]["seed"] == {"seed_specify": True, "seed": 2}
    spec = parity.RUNS[name]
    last = max(step for step, _ in spec["record"])
    budget, step = parity.budget_of(name, tr)
    # the steps a record point averages are evaluations of the port's run
    if parity.is_off_policy(name):
        # 20 envs as the JAX run; its log points are warmup + blocks of
        # 1,000 env-steps apart, and the budget ends at the record's last
        n, ti = tr["n_rollout_threads"], tr["train_interval"]
        evals = tr["warmup_steps"], tr["eval_interval"] // ti * step
        want_tr = {"halfcheetah_6x1_hasac": ((20, 50, 10000, 10000), 800000),
                   "mpe_spread_had3qn": ((20, 50, 10000, 1000), 3000000)}[name]
        assert ((n, ti, tr["warmup_steps"], tr["eval_interval"]), budget) == want_tr
        assert step == 1000 and tr["warmup_steps"] + budget == last
    else:
        T, n = spec["shape"]
        assert (tr["episode_length"], tr["n_rollout_threads"]) == (T, n)
        assert budget >= last
        evals = 0, tr["eval_interval"] * step
    if "window" in spec:
        assert spec["window"][1] == evals[1]
    if "window" in spec or parity.is_off_policy(name):
        # (an on-policy run also evaluates at its last iteration: the
        # football records' last points)
        windows = [parity.window_steps(name, s) for s, _ in spec["record"]]
        assert all(evals[0] < w and (w - evals[0]) % evals[1] == 0 and w <= evals[0] + budget
                   for ws in windows for w in ws)


def _jax_lrs(tx, eps: float, steps: int) -> np.ndarray:
    """The lr of each of ``steps`` optimizer steps of an optax chain of
    clip and Adam: its steps under a constant gradient over those of the
    same Adam at lr 1 (the schedule scales Adam's direction last)."""
    unit = jcommon.make_optimizer(1.0, eps)
    p = jnp.zeros((1,))

    def body(sts, _):
        u, st = tx.update(jnp.ones((1,)), sts[0], p)
        v, st1 = unit.update(jnp.ones((1,)), sts[1], p)
        return (st, st1), u[0] / v[0]

    _, lrs = jax.jit(lambda sts: jax.lax.scan(body, sts, None, length=steps))(
        (tx.init(p), unit.init(p)))
    return np.asarray(lrs, np.float64)


def _port_lrs(opt, steps: int) -> np.ndarray:
    base = opt.adam.param_groups[0]["lr"]
    return np.array([base if opt.lr_schedule is None else opt.lr_schedule(c)
                     for c in range(steps)])


@pytest.mark.parametrize("name", ON_POLICY_RUNS)
def test_lr_schedules_equal_over_the_budget(name):
    """(d) Each runner's actor and critic lr at every optimizer step of the
    run's whole budget, the port's against the JAX runner's optax chain:
    two of the tuned football configs decay linearly to lr/E at the last
    iteration."""
    args, algo_args, env_args = train.resolve_args(_argv(name))
    runner = OnPolicyRunner(args, copy.deepcopy(algo_args), dict(env_args), device="cpu")
    jrunner = JRunner(args, copy.deepcopy(algo_args), dict(env_args))
    assert runner.episodes == jrunner.episodes
    state = runner.init_state(1)
    al, md = algo_args["algo"], algo_args["model"]
    decay = algo_args["train"]["use_linear_lr_decay"]
    assert decay == (name in ("football_pass_and_shoot_with_keeper",
                              "football_counterattack_easy"))
    epochs = al["a2c_epoch"] if args["algo"] == "haa2c" else al["ppo_epoch"]
    for opt, tx, updates, lr in (
            (state.actors[0].opt, jrunner.actors[0].tx,
             epochs * al["actor_num_mini_batch"], md["lr"]),
            (state.critic.opt, jrunner.critic.tx,
             al["critic_epoch"] * al["critic_num_mini_batch"], md["critic_lr"])):
        steps = runner.episodes * updates
        got, want = _port_lrs(opt, steps), _jax_lrs(tx, md["opti_eps"], steps)
        # JAX computes lr·(1 − it/E) in float32: 1 − it/E carries the
        # rounding of it/E, ~6e-8 of lr (an iteration off would be lr/E)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=2e-7 * lr)
        if decay:   # one value an iteration, lr·(1 − e/E)
            assert got[-1] == pytest.approx(lr / runner.episodes, rel=1e-12)
            assert len(set(got[:updates])) == 1 and got[updates] < got[0]


@pytest.mark.parametrize("name", OFF_POLICY_RUNS)
def test_off_policy_lrs_are_the_jax_runners_constants(name):
    """Each off-policy run's optimizers keep one lr over the whole budget,
    as the JAX runner's ``optax.adam(lr)`` does (no decay in the tuned
    configs, so cutting a budget changes nothing before the cut): every
    actor's, the critic's and (HASAC) α's, equal to the JAX runner's;
    HAD3QN has no α."""
    args, algo_args, env_args = train.resolve_args(_argv(name))
    assert algo_args["train"]["use_linear_lr_decay"] is False
    runner = OffPolicyRunner(args, copy.deepcopy(algo_args), dict(env_args), device="cpu")
    jrunner = JOffRunner(args, copy.deepcopy(algo_args), dict(env_args))
    state = runner.init_state(1)
    hasac = args["algo"] == "hasac"
    assert len(state.actors) == len(jrunner.actors) == (6 if hasac else 3)
    for st, jactor in zip(state.actors, jrunner.actors):
        assert [g["lr"] for g in st.opt.param_groups] == [jactor.lr]
        if hasac:
            assert [g["lr"] for g in st.alpha_opt.param_groups] == [jrunner.alpha_lr]
        else:
            assert st.log_alpha is None and st.alpha_opt is None
        assert not hasattr(st.opt, "lr_schedule")
    assert [g["lr"] for g in state.critic.opt.param_groups] == [jrunner.critic.critic_lr]
    assert jactor.lr == algo_args["model"]["lr"] and \
        jrunner.critic.critic_lr == algo_args["model"]["critic_lr"]


@pytest.mark.parametrize("name", list(parity.RUNS))
def test_records_are_the_committed_jax_results(name):
    """Each record of the run table is what the JAX run committed: its
    score-rate or train-return curve, or the round-1 HalfCheetah reading."""
    spec = parity.RUNS[name]
    if spec["metric"] == "eval":   # a window's mean, to the record's digits
        with open(ROOT / spec["source"]) as f:
            curve = dict((int(s), float(v)) for s, v in (line.split(",") for line in f))
        assert sorted(curve)[1] - sorted(curve)[0] == spec["window"][1]
        for step, value in spec["record"]:
            steps = parity.window_steps(name, step)
            assert len(steps) == spec["window"][0] == 5 and steps[-1] == step
            assert parity.value_at(name, curve, step) == pytest.approx(value, abs=5e-5)
        # the middle of the budget and its end
        assert [s for s, _ in spec["record"]] == (
            [1510000, 3010000] if name == "mpe_spread_had3qn" else [2000000, 4000000])
    elif spec["metric"] != "mean_step_reward":
        with open(ROOT / spec["source"]) as f:
            curve = dict((int(s), float(v)) for s, v in (line.split(",") for line in f))
        for step, value in spec["record"]:
            assert curve[step] == value
        if spec["metric"] == "mean_episode_return":   # every point of the curve
            assert [step for step, _ in spec["record"]] == sorted(curve)
    else:
        text = (ROOT / "VALIDATION.md").read_text().splitlines()
        line = text[int(spec["source"].split(":")[1].split()[0]) - 1]
        assert "HalfCheetah-6x1" in line and "HAPPO" in line and "**+4.0**" in line
        assert spec["record"] == ((4000000 // (64 * 1024) * 64 * 1024, 4.0),)


def _curve(mean: float, missing: int = None) -> dict:
    """A seed's evaluations over MPE HAPPO's window ending at 2,000,000,
    spread around ``mean`` (their mean), less the step ``missing``."""
    curve = {1500000: 0.0, 2100000: 0.0}    # evaluations outside the window count for nothing
    for k, step in enumerate(range(1600000, 2000001, 100000)):
        curve[step] = mean + (k - 2) * 0.5
    curve.pop(missing, None)
    return curve


@pytest.mark.parametrize("metric,values,record,want", [
    ("won", [0.99, 1.0, 0.97], 0.997, "meets"),            # within 0.05
    ("won", [1.0, 1.0, 0.98], 0.934, "meets"),             # better than the record
    ("won", [0.937, 0.937, 0.99], 0.997, "misses"),        # the median 0.06 under
    ("won", [0.947, 0.5, 1.0], 0.997, "meets"),            # the median at the edge
    ("mean_step_reward", [4.5, 5.2, 3.0], 4.0, "meets"),   # better
    ("mean_step_reward", [3.65, 3.7, 3.61], 4.0, "meets"),  # within 10 %
    ("mean_step_reward", [3.5, 3.59, 4.4], 4.0, "misses"),  # 3.59 < 3.6
    ("mean_episode_return", [5300.0, 5210.0, 6100.0], 5782.47, "meets"),  # within 10 %
    ("mean_episode_return", [5100.0, 5200.0, 6100.0], 5782.47, "misses"),  # 5200 < 5204.2
    ("mean_episode_return", [2100.0, 1865.4, 1500.0], 2072.57, "meets"),  # 1865.4 > 1865.31
    ("won", [], 0.9, "cut"),
    # windowed (MPE HAPPO at 2,000,000: record -68.102, floor -74.9122): each
    # seed's curve over the window 1.6M-2.0M, or one step short of it
    ("eval", [_curve(-74.91), _curve(-74.91), _curve(-60.0)], -68.102, "meets"),
    ("eval", [_curve(-74.92), _curve(-74.92), _curve(-60.0)], -68.102, "misses"),
    ("eval", [_curve(-50.0), _curve(-80.0), _curve(-60.0)], -68.102, "meets"),
    # the seed at -60 lacks 1.8M: not reached, the median of two -75 misses
    ("eval", [_curve(-60.0, 1800000), _curve(-60.0), _curve(-90.0)], -68.102, "misses"),
    ("eval", [_curve(-60.0, 1600000), _curve(-60.0, 2000000)], -68.102, "cut")])
def test_the_rule(metric, values, record, want):
    """(c) A run meets its record where the median of its seeds is no lower
    than the record less 0.05 (a score rate) or 10 % of it (HalfCheetah's
    mean step reward, an episode return, an MPE window's mean return); a
    seed's window mean needs every step of the window."""
    if metric == "eval":
        values = [v for v in (parity.value_at("mpe_spread_happo", c, 2000000) for c in values)
                  if v is not None]
    med, word = parity.verdict(metric, values, record)
    assert word == want
    if values:
        assert med == statistics.median(values)


def test_table_verdict_needs_every_point(tmp_path):
    """A run's verdict in the table: "meets" only where every point of the
    record meets, and each seed's value printed in its row."""
    name = "football_pass_and_shoot_with_keeper"
    for seed, (early, late) in zip((1, 2, 3), ((0.9, 1.0), (0.91, 0.99), (0.99, 1.0))):
        rec = dict(seed=seed, at_record={"2560000": early, "4966400": late},
                   env_steps_per_s=1.0, wall_s=1.0, concurrent=3, card="x",
                   gae_launches_per_iteration=1.0,
                   gae_in_situ=dict(max_abs_err=0.0, max_abs_return=1.0))
        (tmp_path / f"{name}_s{seed}.json").write_text(json.dumps(rec))
    text, verdicts = parity.table(str(tmp_path), [name, "halfcheetah_6x1_happo"])
    assert verdicts == {name: "misses"}          # the median 0.91 at 2.56M
    # a point not reached does not hide a miss at one that was
    for seed in (1, 2, 3):
        path = tmp_path / f"{name}_s{seed}.json"
        rec = json.loads(path.read_text())
        rec["at_record"]["4966400"] = None
        path.write_text(json.dumps(rec))
    assert parity.table(str(tmp_path), [name])[1] == {name: "misses"}
    rows = [r for r in text.splitlines() if r.startswith(f"| {name}")]
    assert len(rows) == 2 and "s2 0.91" in rows[0] and "| misses |" in rows[0]
    assert "| meets |" in rows[1]


def test_script_end_to_end_on_the_cpu(tmp_path):
    """(b) The script with ``--platform cpu`` on a football run and the
    HalfCheetah run, cut to 2 iterations at tiny widths with one small
    eval: the curves and the JSON of each, and a table row each."""
    runs = ["football_pass_and_shoot_with_keeper", "halfcheetah_6x1_happo"]
    out = subprocess.run(
        [sys.executable, str(SCRIPT), "--platform", "cpu", "--runs", ",".join(runs),
         "--seeds", "1", "--jobs", "2", "--iterations", "2", "--out", str(tmp_path / "out"),
         "--log_dir", str(tmp_path / "runs"), "--", *TINY],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stdout + out.stderr
    for name in runs:
        rec = json.loads((tmp_path / "out" / f"{name}_s1.json").read_text())
        assert rec["iterations"] == 2 and rec["env_steps"] == 160 and rec["card"] == "cpu"
        assert rec["gae_in_situ"]["T"] == 20 and rec["gae_in_situ"]["b"] == 4
        assert rec["gae_in_situ"]["max_abs_err"] == 0.0   # the plain version on the CPU
        assert len(rec["eval_s"]) == 1 and rec["peak_rss_bytes"] > 0
        assert "--seed" in rec["argv"] and rec["argv"][rec["argv"].index("--seed") + 1] == "1"
        for key in ("eval", "mean_step_reward") + (("won",) if "football" in name else ()):
            lines = (tmp_path / "out" / f"{name}_s1_{key}.csv").read_text().splitlines()
            steps = [int(line.split(",")[0]) for line in lines]
            assert steps and steps[-1] == 160
            assert all(np.isfinite(float(line.split(",")[1])) for line in lines)
        assert sum(line.startswith(f"| {name} |") for line in out.stdout.splitlines()) == \
            len(parity.RUNS[name]["record"])
    assert json.loads(out.stdout.splitlines()[-1]) == {
        "verdicts": {name: "cut" for name in runs}, "failed": []}


@pytest.fixture(scope="module")
def off_policy_script(tmp_path_factory):
    """The script on the two off-policy runs at once (``--jobs 2``), cut to 3
    blocks at tiny widths: its output and its ``--out`` directory."""
    tmp = tmp_path_factory.mktemp("off_policy")
    out = subprocess.run(
        [sys.executable, str(SCRIPT), "--platform", "cpu", "--runs", ",".join(OFF_POLICY_RUNS),
         "--seeds", "1", "--jobs", "2", "--iterations", "3", "--out", str(tmp / "out"),
         "--log_dir", str(tmp / "runs"), "--", *TINY_OFF],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stdout + out.stderr
    return out, tmp / "out"


@pytest.mark.parametrize("name", OFF_POLICY_RUNS)
def test_script_trains_the_off_policy_run_on_the_cpu(name, off_policy_script):
    """Each off-policy run (HASAC HalfCheetah, HAD3QN MPE) with ``--platform
    cpu``, cut to 3 blocks at tiny widths: no GAE launch, the ring's rows at
    the end min(warmup + steps, buffer_size) = min(40 + 60, 70), every one
    of them with its availability under discrete actions (HAD3QN), a record
    (with its evaluation, the α, the critic loss and the clamped log-std
    share) every 2 blocks and at the last, the train-return curve written."""
    out, out_dir = off_policy_script
    hasac = name == "halfcheetah_6x1_hasac"
    rec = json.loads((out_dir / f"{name}_s1.json").read_text())
    assert (rec["iterations"], rec["env_steps"], rec["gae_launches"]) == (3, 60, 0)
    assert rec["gae_in_situ"] is None and rec["ring_rows"] == 70
    assert rec["avail_rows"] == (None if hasac else [70] * 6)   # 3 agents, now and next
    assert len(rec["collect_s"]) == len(rec["train_s"]) == 3 and len(rec["eval_s"]) == 2
    for key in ("mean_episode_return", "eval"):
        lines = (out_dir / f"{name}_s1_{key}.csv").read_text().splitlines()
        assert [int(line.split(",")[0]) for line in lines] == [80, 100]
        assert all(np.isfinite(float(line.split(",")[1])) for line in lines)
    # at each record: every agent's α, the critic's α, the critic loss and
    # each agent's share of log-std elements under the floor (HAD3QN: none)
    assert [r["steps"] for r in rec["learners"]] == [80, 100]
    for r in rec["learners"]:
        assert np.isfinite(r["critic_loss"])
        if hasac:
            assert len(r["alpha"]) == 6 and all(0 < a < 8 for a in r["alpha"] + [r["critic_alpha"]])
            assert len(r["log_std_below_min"]) == 6
            assert all(0 <= x <= 1 for x in r["log_std_below_min"])
        else:
            assert r["alpha"] == [None] * 3 and r["critic_alpha"] is None
            assert r["log_std_below_min"] == [None] * 3
    rows = [r for r in out.stdout.splitlines() if r.startswith(f"| {name} |")]
    assert len(rows) == len(parity.RUNS[name]["record"])
    assert all("| cut |" in r and "0; ring rows 70" in r for r in rows)
    # a ring smaller than the run's rows, an availability row not written:
    # the check catches a wrong count
    want = dict(launches=0, ring_rows=70, discrete=not hasac)
    with pytest.raises(AssertionError, match="ring holds 69 rows"):
        parity.check_rank(name, 1, "cpu", 0, 3, None, 69, want, rec["avail_rows"])
    with pytest.raises(AssertionError, match="gae launched 1 times"):
        parity.check_rank(name, 1, "cpu", 1, 3, None, 70, want, rec["avail_rows"])
    if not hasac:
        for avail in ([70] * 5 + [69], None):
            with pytest.raises(AssertionError, match="availability written"):
                parity.check_rank(name, 1, "cpu", 0, 3, None, 70, want, avail)
    else:
        with pytest.raises(AssertionError, match="availability kept"):
            parity.check_rank(name, 1, "cpu", 0, 3, None, 70, want, [70])


def test_instruments_count_the_clamped_log_std(tmp_path):
    """The clamped share counts the raw log-std elements under the floor
    in the samples each actor's loss goes through, per actor, since the
    last record: actor 1's log-std head planted at -10 counts every element,
    the others (near 0) none."""
    import torch

    from harl_tpu_torch.logging.logger import TrainLogger

    argv = [*_argv("halfcheetah_6x1_hasac"), *TINY_OFF, "--platform", "cpu"]
    args, algo_args, env_args = train.resolve_args(argv)
    runner = OffPolicyRunner(args, algo_args, env_args, device="cpu")
    state = runner.init_state(1)
    with torch.no_grad():
        head = state.actors[1].net.log_std
        head.weight.zero_()
        head.bias.fill_(-10.0)
    logger = TrainLogger(args, algo_args, env_args, runner.n_agents)
    with parity.Instruments("cpu") as ins:
        state = runner.warmup_block(state)
        state, _ = runner.train_block(state)
        logger.log_episode({"steps": 1})
        logger.log_episode({"steps": 2})     # no update between: nothing counted
    shares = ins.learners[0]["log_std_below_min"]
    assert shares[1] == 1.0 and shares[0] == shares[2] == 0.0
    assert ins.learners[1]["log_std_below_min"] == [None] * 6
    assert ins.pending is None


def test_table_card_column_says_ranks_and_cards(tmp_path):
    """A record without ``ranks`` (the committed one-card runs) keeps its card as
    it was; a run over four ranks on four cards says so."""
    name = "halfcheetah_6x1_happo"
    base = dict(at_record={"3997696": 4.0}, env_steps_per_s=1.0, wall_s=1.0, concurrent=3,
                card="NVIDIA H100 80GB HBM3, 700.00 W", platform="cuda",
                gae_launches_per_iteration=1.0,
                gae_in_situ=dict(max_abs_err=0.0, max_abs_return=1.0))
    (tmp_path / f"{name}_s1.json").write_text(json.dumps(dict(base, seed=1)))
    text, _ = parity.table(str(tmp_path), [name])
    assert text.splitlines()[-1].endswith("| NVIDIA H100 80GB HBM3, 700.00 W |")
    (tmp_path / f"{name}_s1.json").write_text(json.dumps(dict(base, seed=1, ranks=4, cards=4)))
    text, _ = parity.table(str(tmp_path), [name])
    assert text.splitlines()[-1].endswith(
        "| 4 ranks on 4 cards: NVIDIA H100 80GB HBM3, 700.00 W |")
    committed, _ = parity.table(str(ROOT / "validation_torch"), list(parity.RUNS))
    assert all(row.endswith("| NVIDIA H100 80GB HBM3, 700.00 W |")
               for row in committed.splitlines()[2:])


def test_script_trains_a_run_over_two_ranks_on_the_cpu(tmp_path):
    """``--ranks 2``: one child process a rank (``--num_processes 2``),
    rank 0 alone writing the record, which says 2 ranks; each rank holds
    its GAE at its own columns (b = 4 / 2)."""
    name = "halfcheetah_6x1_happo"
    tiny = ["--n_rollout_threads", "4", "--episode_length", "20", "--hidden_sizes", "[8, 8]",
            "--episode_limit", "30", "--ppo_epoch", "1", "--critic_epoch", "1"]
    out = subprocess.run(
        [sys.executable, str(SCRIPT), "--platform", "cpu", "--runs", name, "--seeds", "1",
         "--ranks", "2", "--iterations", "1", "--out", str(tmp_path / "out"),
         "--log_dir", str(tmp_path / "runs"), "--", *tiny, "--use_eval", "False"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stdout + out.stderr
    assert sorted(p.name for p in (tmp_path / "out").glob("*.json")) == [f"{name}_s1.json"]
    rec = json.loads((tmp_path / "out" / f"{name}_s1.json").read_text())
    assert (rec["ranks"], rec["cards"], rec["iterations"]) == (2, 0, 1)
    assert (rec["gae_in_situ"]["T"], rec["gae_in_situ"]["b"]) == (20, 2)
    assert "--num_processes" in rec["argv"] and "--process_id" in rec["argv"]
    rank1 = (tmp_path / "runs" / f"{name}_s1_rank1.log").read_text()
    assert "a rank of 2, 1 iterations" in rank1 and "T=20, b=2" in rank1
    assert "| 2 ranks on the CPU |" in out.stdout


HASAC = "halfcheetah_6x1_hasac"
JAX_CPU_SEEDS = sorted((ROOT / parity.SPREAD[HASAC]["jax"]).glob(f"{HASAC}_s*.json"))


def _write_curves(where: Path, values: list, step: int = 210000) -> None:
    """One curve a seed (1, 2, ...) in ``where``, the value at ``step``
    and a training record 1,000 env-steps before it."""
    for seed, value in enumerate(values, 1):
        parity.write_curves(str(where), HASAC, seed,
                            {"mean_episode_return": [(step - 1000, 0.0), (step, value)]})


@pytest.mark.parametrize("jax,port,want", [
    # the port's median inside JAX's range, p >= 0.05
    ([1500.0, 1800.0, 2100.0, 2300.0, 1200.0], [1400.0, 1900.0, 1700.0, 2000.0], "within"),
    # the port's median below every JAX value
    ([1500.0, 1800.0, 2100.0, 2300.0, 1900.0], [900.0, 1000.0, 1100.0, 1600.0], "outside"),
    # the median inside the range, but every port seed under five of the
    # six JAX values: p < 0.05
    ([1000.0, 5000.0, 5100.0, 5200.0, 5300.0],
     [1100.0, 1150.0, 1200.0, 1250.0, 1300.0, 1350.0, 1400.0, 1450.0], "outside"),
    # a step missing on one side
    ([], [1400.0, 1900.0], "not measured"),
    ([1500.0, 1800.0], [], "not measured")])
def test_spread_rule_on_made_up_curves(tmp_path, jax, port, want):
    """The spread reading of a step: the port's median inside the range of
    the JAX CPU seeds and the TPU record, and the two-sided Mann-Whitney U
    p-value of the port's seeds against those six at least 0.05; a step
    that one side did not reach is not measured, and closes nothing."""
    from scipy.stats import mannwhitneyu

    _write_curves(tmp_path / "jax", jax)
    _write_curves(tmp_path / "port", port)
    _write_curves(tmp_path / "apart", [1.0, 2.0])
    spread = dict(jax=str(tmp_path / "jax"), port=str(tmp_path / "port"), port_label="port",
                  apart=("earlier", (str(tmp_path / "apart"),)))
    text, readings, within = parity.spread_table(HASAC, spread)
    assert readings == {210000: want} and within == (want == "within")
    record = dict(parity.RUNS[HASAC]["record"])[210000]
    rows = [r for r in text.splitlines() if r.startswith("| 210,000 |")]
    assert len(rows) == 1 and f"| {want} |" in rows[0] and f"| {record} |" in rows[0]
    assert "s2 2; median 2 [1, 2], n=2" in rows[0]      # the earlier physics, apart
    if jax and port:
        p = mannwhitneyu(port, [*jax, record], alternative="two-sided").pvalue
        assert f"| {p:.3g} |" in rows[0]
        assert (want == "within") == (min(jax + [record]) <= statistics.median(port)
                                      <= max(jax + [record]) and p >= parity.SPREAD_P)


def test_spread_table_on_the_committed_curves():
    """``--spread halfcheetah_6x1_hasac`` on the committed curves: JAX's
    CPU seeds 1-5 and the TPU record at 210k, 410k and 610k, the port's
    repaired-physics seeds 1-8 to 410k and 1-3 to 610k, PR 15's physics
    seeds 1-5 apart; 810k is not measured on JAX's side; each reading is
    the rule's on those values."""
    from scipy.stats import mannwhitneyu

    sp = parity.SPREAD[HASAC]
    text, readings, within = parity.spread_table(HASAC)
    assert list(readings) == [210000, 410000, 610000, 810000]
    assert readings[810000] == "not measured"
    record = dict(parity.RUNS[HASAC]["record"])
    curves = {k: parity.seed_curves(dirs, HASAC, "mean_episode_return")
              for k, dirs in (("jax", [sp["jax"]]), ("port", [sp["port"]]),
                              ("apart", sp["apart"][1]))}
    for step, seeds in ((210000, (8, 5, 5)), (410000, (8, 5, 5)), (610000, (3, 5, 5))):
        port = [c[step] for c in curves["port"].values() if step in c]
        jax = [c[step] for c in curves["jax"].values() if step in c]
        apart = [c[step] for c in curves["apart"].values() if step in c]
        assert (len(port), len(jax), len(apart)) == seeds
        jax.append(record[step])
        p = mannwhitneyu(port, jax, alternative="two-sided").pvalue
        inside = min(jax) <= statistics.median(port) <= max(jax)
        assert readings[step] == ("within" if inside and p >= parity.SPREAD_P else "outside")
        row = next(r for r in text.splitlines() if r.startswith(f"| {step:,} |"))
        assert f"| {p:.3g} |" in row and f"n={len(port)}" in row
    assert within == all(readings[s] == "within" for s in (210000, 410000, 610000))
    out = subprocess.run([sys.executable, str(SCRIPT), "--spread", HASAC], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[-1]) == {
        "spread": {str(s): w for s, w in readings.items()},
        "within_at_every_measured_step": within}


@pytest.mark.parametrize("path", JAX_CPU_SEEDS, ids=lambda p: p.stem)
def test_jax_cpu_seeds_are_the_record_run(path):
    """Each committed JAX CPU seed ran the record's own command line with
    only the seed and the budget changed (and its run directories placed
    outside the checkout), to 610k at least, on the CPU; its curve holds
    the values at the record's steps."""
    rec = json.loads(path.read_text())
    name, seed = rec["run"], rec["seed"]
    got = jax_resolve([str(ROOT / a) if a.startswith("tuned_configs/") else a
                       for a in rec["argv"]])
    want = jax_resolve(_argv(name, seed)[:-2])       # without the port's --exp_name
    budget = got[1]["train"]["num_env_steps"]
    assert got[1]["seed"] == {"seed_specify": True, "seed": seed}
    assert got[1]["logger"]["log_dir"] == "<log_dir>"
    got[1]["train"]["num_env_steps"] = want[1]["train"]["num_env_steps"]
    got[1]["logger"]["log_dir"] = want[1]["logger"]["log_dir"]
    assert got == want
    tr = want[1]["train"]
    step = tr["n_rollout_threads"] * tr["train_interval"]
    assert tr["warmup_steps"] + budget >= 610000 and budget % step == 0
    assert rec["argv"] == parity.jax_argv(name, seed, budget // step, "<log_dir>")
    assert rec["command"] == "python -m harl_tpu.train" and rec["platform"] == "cpu"
    assert rec["jax_version"] and rec["device"] and rec["cores"] >= 1 and rec["wall_s"] > 0
    assert rec["concurrent"] >= 1 and rec["env_steps"] == tr["warmup_steps"] + budget
    curve = parity.seed_curves([parity.SPREAD[name]["jax"]], name, rec["metric"])[seed]
    for s, _ in parity.RUNS[name]["record"]:
        assert rec["at_record"][str(s)] == curve.get(s)
