"""Port: data parallelism over two gloo ranks on the CPU (``parallel/mesh.py``).

The JAX package's data parallelism (``harl_tpu/parallel/mesh.py``) shards
the env axis and lets GSPMD compute exactly what the unsharded program
computes, so a run over W ranks must equal the one-rank run at the same
global ``n_rollout_threads`` up to the order of float sums. Each case here
runs on two spawned ranks (``parallel/launch.py``, a free port, a timeout)
and is held against the one-rank port run of this process: discrete
outputs exactly, floats at RTOL/ATOL, and the ranks' replicas (networks,
optimizer moments, ValueNorm, replay buffer) bitwise equal. One HAPPO
iteration at W=2 and at W=4, with the JAX draws replayed, is held against
JAX's ``_train_iteration`` on a mesh of as many devices at the runner
tolerances; the
CLI runs two ranks by spawning (``--n_devices 2``) and as two hosts
(``--num_processes 2``).
"""
import copy
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from harl_tpu_torch import train
from harl_tpu_torch.parallel.launch import free_port, spawn_ranks
from harl_tpu_torch.parallel.mesh import Mesh, ShardedNoise
from harl_tpu_torch.runners import common
from harl_tpu_torch.runners.off_policy import OffPolicyRunner
from harl_tpu_torch.runners.on_policy import OnPolicyRunner
from harl_tpu_torch.utils.config_tools import get_defaults_yaml_args

ROOT = Path(__file__).resolve().parent.parent
# the order of float sums (a rank sums its rows, the all-reduce adds the
# ranks' sums), carried through two iterations or blocks of Adam steps
RTOL, ATOL = 1e-5, 1e-6
# HATRPO's step solves (H + 0.1·I)x = g by conjugate gradients and scales
# it to the KL radius: on this tiny net a 1e-7 perturbation of the
# parameters moves the next iteration's parameters by ~1e-4, so one
# iteration is compared, at the sums' order carried through CG.
TRPO_RTOL, TRPO_ATOL = 1e-4, 1e-5
WORLD = 2


def _on_policy(algo_name, env, **over):
    algo_args, env_args = get_defaults_yaml_args(algo_name, env)
    algo_args["model"].update(hidden_sizes=[8, 8])
    if env == "mamujoco_jax":
        algo_args["train"].update(n_rollout_threads=4, episode_length=8)
        env_args.update(agent_conf="2x3", episode_limit=5)
    else:
        algo_args["train"].update(n_rollout_threads=4, episode_length=10)
        algo_args["model"].update(use_recurrent_policy=True, data_chunk_length=5)
        env_args.update(map_name="3m", state_type="FP", episode_limit=6)
    for section, kv in over.items():
        algo_args[section].update(kv)
    return {"algo": algo_name, "env": env}, algo_args, env_args


def _off_policy(env, **algo):
    algo_args, env_args = get_defaults_yaml_args("hasac", env)
    algo_args["train"].update(n_rollout_threads=4, warmup_steps=8, train_interval=2)
    algo_args["algo"].update(batch_size=10, buffer_size=100, n_step=2, **algo)
    algo_args["model"].update(hidden_sizes=[8, 8])
    if env == "mamujoco_jax":
        env_args.update(agent_conf="2x3", episode_limit=3)
    else:
        env_args.update(map_name="3m", episode_limit=4, state_type="FP")
    return {"algo": "hasac", "env": env}, algo_args, env_args


MINI = dict(ppo_epoch=2, critic_epoch=2, actor_num_mini_batch=2, critic_num_mini_batch=2)
CASES = {
    # EP HAPPO, two minibatches (rows t·B + b: every minibatch mixes the ranks')
    "happo": (_on_policy("happo", "mamujoco_jax", algo=MINI), 2),
    # recurrent FP HAPPO on SMACLite 3m: chunks b·(T/L) + c, per-agent critic rows
    "happo_fp_gru": (_on_policy("happo", "smaclite", algo=MINI), 2),
    # one-row minibatches: at every step one rank's share is empty
    "happo_empty_share": (_on_policy("happo", "mamujoco_jax", train=dict(
        n_rollout_threads=2, episode_length=2), algo=dict(
        ppo_epoch=1, critic_epoch=1, actor_num_mini_batch=4, critic_num_mini_batch=4)), 2),
    "hatrpo": (_on_policy("hatrpo", "mamujoco_jax", algo=dict(
        critic_epoch=2, critic_num_mini_batch=2)), 1),
    "mappo_share_param": (_on_policy("mappo", "mamujoco_jax", algo=dict(
        MINI, share_param=True)), 2),
    "hasac": (_off_policy("mamujoco_jax"), 2),
    "hasac_fp": (_off_policy("smaclite", auto_alpha=True), 2),
}


def _drive(case, mesh):
    """``steps`` iterations (on-policy) or warmup + blocks (off-policy) of
    ``case`` on this rank; returns (state tensors, metrics of each step)."""
    (args, algo_args, env_args), steps = CASES[case]
    if args["algo"] == "hasac":
        runner = OffPolicyRunner(args, copy.deepcopy(algo_args), env_args, device="cpu")
        runner.use_mesh(mesh)
        state = runner.warmup_block(runner.init_state(0))
        metrics = []
        for _ in range(steps):
            state, cm = runner.collect_block(state)
            state, tm = runner.train_block(state)
            metrics.append({**cm, **tm})
    else:
        runner = OnPolicyRunner(args, copy.deepcopy(algo_args), env_args, device="cpu")
        runner.use_mesh(mesh)
        state = runner.init_state(0)
        metrics = []
        for _ in range(steps):
            state, m = runner.train_iteration(state)
            metrics.append({k: v for k, v in m.items() if torch.is_tensor(v)})
    return common.replica_tensors(state), metrics


def _rank_cases(mesh):
    """Every case on this rank, with its replicas' mismatch."""
    out = {}
    for case in CASES:
        tensors, metrics = _drive(case, mesh)
        out[case] = (tensors, metrics, mesh.replica_mismatch(tensors))
    return out


@pytest.fixture(scope="module")
def two_ranks():
    return spawn_ranks(_rank_cases, WORLD, timeout_s=240)


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_equal_one_rank(two_ranks, case):
    rtol, atol = (TRPO_RTOL, TRPO_ATOL) if case == "hatrpo" else (RTOL, ATOL)
    tensors, metrics = _drive(case, None)
    for rank in range(WORLD):
        got, got_metrics, mismatch = two_ranks[rank][case]
        assert mismatch == (0, 0.0)   # replicas bitwise equal
        assert len(got) == len(tensors)
        for a, b in zip(got, tensors):
            if a.dtype.is_floating_point:
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol, atol=atol)
            else:
                assert torch.equal(a, b)
        for m, ref in zip(got_metrics, metrics):
            assert set(m) == set(ref)
            for k in ("episode_count", "dead_ratio"):
                if k in ref:
                    assert float(m[k]) == float(ref[k]), k    # counts: exact
            for k, v in ref.items():
                np.testing.assert_allclose(m[k].numpy(), v.numpy(), rtol=rtol, atol=atol,
                                           err_msg=k)


def test_ranks_must_divide_the_env_batch():
    (args, algo_args, env_args), _ = CASES["happo"]
    runner = OnPolicyRunner(args, copy.deepcopy(algo_args), env_args, device="cpu")
    with pytest.raises(ValueError, match="n_rollout_threads 4 does not split over 3 ranks"):
        runner.use_mesh(Mesh(0, 3, "cpu"))
    (args, algo_args, env_args), _ = CASES["hasac"]
    runner = OffPolicyRunner(args, copy.deepcopy(algo_args), env_args, device="cpu")
    with pytest.raises(ValueError, match="does not split"):
        runner.use_mesh(Mesh(1, 3, "cpu"))


def test_sharded_noise_draws_the_global_batch_and_keeps_its_rows():
    """Rank r's draws are rows [r·B/W, (r+1)·B/W) of the one-rank draws;
    permutations and indices are the global ones."""
    def draws(noise, rows):
        g = noise.base.generator if hasattr(noise, "base") else noise.generator
        g.manual_seed(3)
        return (noise.action_noise((rows, 2)), noise.gumbel_noise((rows, 3)),
                noise.uniform((rows, 1)), noise.randint((rows, 1), 5),
                *noise.reset_noise(rows, (("uniform", 2), ("randint", 1, 4))),
                noise.permutation(6), noise.indices(4, 9))

    from harl_tpu_torch.utils.noise import GeneratorNoise

    full = draws(GeneratorNoise(torch.Generator(), "cpu"), 6)
    for rank in range(3):
        sharded = ShardedNoise(GeneratorNoise(torch.Generator(), "cpu"), Mesh(rank, 3, "cpu"), 6)
        got = draws(sharded, 2)
        for a, b in zip(got[:6], full[:6]):
            assert torch.equal(a, b[2 * rank: 2 * rank + 2])
        for a, b in zip(got[6:], full[6:]):
            assert torch.equal(a, b)
        with pytest.raises(ValueError, match="rows on a rank holding 2"):
            sharded.action_noise((3, 2))


# ------------------------------------------------ against JAX's 2-device mesh
JB, JT, JN, DOF = 8, 8, 6, 9


def _jax_configs():
    algo_args, env_args = get_defaults_yaml_args("happo", "mamujoco_jax")
    algo_args["train"].update(n_rollout_threads=JB, episode_length=JT, num_env_steps=10 ** 6)
    algo_args["model"].update(hidden_sizes=[16, 16])
    algo_args["algo"].update(ppo_epoch=2, critic_epoch=2, actor_num_mini_batch=2,
                             critic_num_mini_batch=2)
    env_args.update(scenario="HalfCheetah-v2", agent_conf="6x1", episode_limit=5)
    return algo_args, env_args


def _replayed_rank(mesh, queue, weights):
    """The W-rank port iteration on the replayed JAX draws."""
    from tests.torch_replay import ReplayNoise

    algo_args, env_args = _jax_configs()
    noise = ReplayNoise()
    for name, items in queue.items():
        getattr(noise, name).extend(items)
    runner = OnPolicyRunner({"algo": "happo", "env": "mamujoco_jax"}, algo_args, env_args,
                            device="cpu", noise=noise)
    runner.use_mesh(mesh)
    state = runner.init_state(0)
    for st, sd in zip(state.actors, weights["actors"]):
        st.net.load_state_dict(sd)
    state.critic.net.load_state_dict(weights["critic"])
    state, metrics = runner.train_iteration(state)
    assert noise.drained()
    return dict(actors=[st.net.state_dict() for st in state.actors],
                critic=state.critic.net.state_dict(), value_norm=state.value_norm,
                metrics={k: v for k, v in metrics.items() if torch.is_tensor(v)},
                mismatch=mesh.replica_mismatch(common.replica_tensors(state)))


def test_two_ranks_match_jax_on_a_two_device_mesh(jax_iteration_draws):
    _match_jax_on_a_mesh(2, *jax_iteration_draws)


def test_four_ranks_match_jax_on_a_four_device_mesh(jax_iteration_draws):
    """Two envs a rank: JAX's four-device CPU mesh against four gloo ranks."""
    _match_jax_on_a_mesh(4, *jax_iteration_draws)


@pytest.fixture(scope="module")
def jax_iteration_draws():
    """The JAX runner and state both mesh tests start from, its weights as
    the port's state dicts, and the draws of its one iteration, made once."""
    import jax

    from harl_tpu.runners.on_policy import OnPolicyRunner as JRunner
    from harl_tpu_torch.utils import convert
    from tests.test_torch_runner import _perms
    from tests.torch_replay import reset_noise, step_reset_noise

    algo_args, env_args = _jax_configs()
    jr = JRunner({"algo": "happo", "env": "mamujoco_jax", "exp_name": "dp"},
                 copy.deepcopy(algo_args), copy.deepcopy(env_args))
    js = jr.init_state(0)
    weights = dict(actors=[convert.policy_state_dict(jax.tree.map(np.asarray, st.params))
                           for st in js.actors],
                   critic=convert.vnet_state_dict(jax.tree.map(np.asarray, js.critic.params)))
    # the draws of one iteration (tests/test_torch_runner.py), at the global batch
    _, k_env, *_ = jax.random.split(jax.random.PRNGKey(0), JN + 2)
    queue = dict(resets=[reset_noise(jax.random.split(k_env, JB), DOF)], actions=[], perms=[])
    _, k_roll, k_order, k_update, k_critic = jax.random.split(js.rng, 5)
    for k in jax.random.split(k_roll, JT):
        k_act, k_step = jax.random.split(k)
        for i in range(JN):
            queue["actions"].append(np.asarray(jax.random.normal(jax.random.fold_in(k_act, i),
                                                                 (JB, 1))))
        queue["resets"].append(step_reset_noise(k_step, JB, DOF))
    perm = np.asarray(jax.random.permutation(k_order, JN))
    queue["perms"].append(perm)
    key = k_update
    for _ in perm:
        key, k_up = jax.random.split(key)
        queue["perms"].extend(_perms(k_up, 2))
    queue["perms"].extend(_perms(k_critic, 2))
    return jr, js, weights, queue


def _match_jax_on_a_mesh(world, jr, js, weights, queue):
    """One HAPPO iteration at the global batch JB on ``world`` ranks, with
    the JAX draws replayed, against JAX's ``_train_iteration`` on a mesh of
    ``world`` CPU devices (``tests/conftest.py`` gives eight)."""
    import jax

    from harl_tpu.parallel.mesh import make_mesh, shard_train_state
    from harl_tpu_torch.utils import convert
    from tests.test_torch_runner import DATA_ATOL, DATA_RTOL, PARAM_ATOL, PARAM_RTOL

    # JAX's data parallelism: the state sharded over two devices, returns
    # by the associative scan, as OnPolicyRunner.run(mesh=…) sets them
    jr.returns_impl = "assoc"
    js2, jm = jr._train_iteration(shard_train_state(js, make_mesh(world), JB))

    ranks = spawn_ranks(_replayed_rank, world, (queue, weights), timeout_s=180)
    assert len(ranks) == world

    def close(a, b, rtol=DATA_RTOL, atol=DATA_ATOL):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)

    for got in ranks:
        assert got["mismatch"] == (0, 0.0)
        for k in ("actor_stats", "value_loss", "critic_grad_norm", "mean_step_reward",
                  "dead_ratio", "episode_return_sum", "episode_count"):
            close(got["metrics"][k], jm[k])
        for sd, jst in zip(got["actors"], js2.actors):
            ref = convert.policy_state_dict(jax.tree.map(np.asarray, jst.params))
            for k, v in sd.items():
                close(v, ref[k], PARAM_RTOL, PARAM_ATOL)
        ref = convert.vnet_state_dict(jax.tree.map(np.asarray, js2.critic.params))
        for k, v in got["critic"].items():
            close(v, ref[k], PARAM_RTOL, PARAM_ATOL)
        for name in ("running_mean", "running_mean_sq", "debiasing_term"):
            close(getattr(got["value_norm"], name), getattr(js2.value_norm, name))


# ------------------------------------------------------------------ the CLI
TINY_MPE = ["--algo", "happo", "--env", "pettingzoo_mpe", "--platform", "cpu",
            "--n_rollout_threads", "4", "--episode_length", "10", "--hidden_sizes", "[8, 8]",
            "--num_env_steps", "80", "--scenario", "simple_spread_v2", "--max_cycles", "10",
            "--use_eval", "False", "--log_interval", "1", "--eval_interval", "1"]


def _run_dirs(log_dir):
    return [p for p in Path(log_dir).rglob("seed-*") if p.is_dir()]


def _records(run_dir):
    lines = (Path(run_dir) / "logs" / "progress.txt").read_text().splitlines()
    return [json.loads(line) for line in lines]


def test_cli_spawns_ranks_and_rank0_writes(tmp_path):
    run_dir = train.main(TINY_MPE + ["--n_devices", "2", "--log_dir", str(tmp_path)])
    assert _run_dirs(tmp_path) == [Path(run_dir)]
    recs = _records(run_dir)
    assert [r["steps"] for r in recs] == [40, 80]   # rank 0 alone logs, global steps
    assert all(math.isfinite(r["value_loss"]) for r in recs)
    assert sorted(p.name for p in (Path(run_dir) / "models").iterdir()) == ["ckpt_40",
                                                                           "ckpt_80"]


def test_cli_two_hosts(tmp_path):
    """Two OS processes, as two hosts: process 0 alone makes a run dir."""
    coordinator = f"localhost:{free_port()}"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "harl_tpu_torch.train", *TINY_MPE, "--num_processes", "2",
         "--coordinator", coordinator, "--process_id", str(k),
         "--log_dir", str(tmp_path / f"host{k}")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for k in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=180)[0])
        finally:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    (run_dir,) = _run_dirs(tmp_path / "host0")
    assert not (tmp_path / "host1").exists()
    assert [r["steps"] for r in _records(run_dir)] == [40, 80]
