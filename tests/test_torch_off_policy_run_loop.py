"""Port parity: the off-policy ``run`` loop's logged series.

The train-return series that the learning-parity verdict reads is made by
each runner's ``run`` loop (``harl_tpu/runners/off_policy.py:951-1030``,
``harl_tpu_torch/runners/off_policy.py`` ``run``): every block's completed
episodes accumulate, and each record divides the sum over the blocks
since the last record that saw an episode end. Here both loops are given
the same blocks, stubbed (the same float32 ``episode_return_sum`` and
``episode_count`` a block, the same critic loss, the same evaluation
return), and must log the same records (steps, train return, critic loss,
evaluation) at the same blocks, evaluate at the same blocks and write
checkpoints at the same steps, at the tuned config's ``blocks_per_eval``
of 200 and at a small one.
"""
import copy

import numpy as np
import pytest

import harl_tpu.utils.checkpoint as jckpt
from harl_tpu.runners.off_policy import OffPolicyRunner as JRunner
from harl_tpu.utils.config_tools import get_defaults_yaml_args as jdefaults
from harl_tpu_torch.runners import off_policy as port_off_policy
from harl_tpu_torch.runners.off_policy import OffPolicyRunner

import torch

B, INTERVAL = 4, 5
ARGS = {"algo": "hasac", "env": "mamujoco_jax", "exp_name": "run_loop"}


def _configs(blocks_per_eval, total_blocks):
    algo_args, env_args = jdefaults("hasac", "mamujoco_jax")
    algo_args["train"].update(n_rollout_threads=B, warmup_steps=3 * B, train_interval=INTERVAL,
                              num_env_steps=total_blocks * INTERVAL * B,
                              eval_interval=blocks_per_eval * INTERVAL)
    algo_args["algo"].update(batch_size=8, buffer_size=100)
    algo_args["model"].update(hidden_sizes=[8, 8])
    algo_args["eval"] = dict(use_eval=True, n_eval_rollout_threads=2, eval_episodes=2)
    env_args.update(scenario="HalfCheetah-v2", agent_conf="6x1", episode_limit=20)
    return algo_args, env_args


def _blocks(total_blocks, seed=0):
    """Per block: (episode_return_sum, episode_count, critic_loss, eval
    return) as float32, with long stretches where no episode ends."""
    rng = np.random.default_rng(seed)
    counts = rng.choice([0, 0, 0, 1, 2], size=total_blocks).astype(np.float32)
    counts[: total_blocks // 3] = 0            # a record with no episode yet: nan
    counts[total_blocks // 2: total_blocks // 2 + total_blocks // 4] = 0
    sums = (counts * rng.normal(3000, 800, total_blocks)).astype(np.float32)
    return sums, counts, rng.normal(20, 5, total_blocks).astype(np.float32), \
        rng.normal(4000, 500, total_blocks).astype(np.float32)


class Script:
    """The stubbed blocks of one run, and what the loop did with them."""

    def __init__(self, total_blocks):
        self.sums, self.counts, self.losses, self.evals = _blocks(total_blocks)
        self.collected = self.trained = 0
        self.eval_at, self.saved_at = [], []

    def collect(self, wrap):
        i = self.collected
        self.collected += 1
        return dict(episode_return_sum=wrap(self.sums[i]), episode_count=wrap(self.counts[i]),
                    mean_step_reward=wrap(np.float32(1.0)))

    def train(self, wrap):
        self.trained += 1
        return dict(critic_loss=wrap(self.losses[self.trained - 1]))

    def evaluate(self):
        self.eval_at.append(self.trained)
        return float(self.evals[self.trained - 1]), {}


def _jax_run(algo_args, env_args, total_blocks, monkeypatch):
    jr = JRunner(ARGS, copy.deepcopy(algo_args), copy.deepcopy(env_args))
    sc = Script(total_blocks)
    jr._warmup = lambda s: s
    jr._collect = lambda s: (s, sc.collect(np.asarray))
    jr._train = lambda s: (s, sc.train(np.asarray))
    jr.evaluate = lambda state, n, e: sc.evaluate()
    monkeypatch.setattr(jckpt, "save_state", lambda d, state, steps: sc.saved_at.append(steps))
    monkeypatch.setattr(jckpt, "prune_checkpoints", lambda d, keep: None)
    _, history = jr.run(seed=1, save_dir="unused")
    return history, sc


def _port_run(algo_args, env_args, total_blocks, monkeypatch):
    tr = OffPolicyRunner(ARGS, copy.deepcopy(algo_args), copy.deepcopy(env_args), device="cpu")
    sc = Script(total_blocks)
    wrap = lambda x: torch.tensor(x)
    monkeypatch.setattr(tr, "warmup_block", lambda s: s)
    monkeypatch.setattr(tr, "collect_block", lambda s: (s, sc.collect(wrap)))
    monkeypatch.setattr(tr, "train_block", lambda s: (s, sc.train(wrap)))
    monkeypatch.setattr(tr, "evaluate", lambda state, n, e: sc.evaluate())
    monkeypatch.setattr(tr, "checkpoint", lambda state: {})
    ck = port_off_policy.checkpoint
    monkeypatch.setattr(ck, "save_state", lambda d, payload, steps: sc.saved_at.append(steps))
    monkeypatch.setattr(ck, "prune_checkpoints", lambda d, keep: None)
    _, history = tr.run(seed=1, save_dir="unused")
    return history, sc


@pytest.mark.parametrize("blocks_per_eval,total_blocks", [(200, 1010), (3, 20)])
def test_both_run_loops_log_the_same_series(blocks_per_eval, total_blocks, monkeypatch):
    algo_args, env_args = _configs(blocks_per_eval, total_blocks)
    jhist, jsc = _jax_run(algo_args, env_args, total_blocks, monkeypatch)
    thist, tsc = _port_run(algo_args, env_args, total_blocks, monkeypatch)
    assert jsc.trained == tsc.trained == total_blocks
    n_records = total_blocks // blocks_per_eval + (total_blocks % blocks_per_eval > 0)
    assert len(jhist) == len(thist) == n_records
    keys = ("steps", "mean_episode_return", "critic_loss", "eval_return")
    for j, t in zip(jhist, thist):
        assert set(j) == set(t)
        for k in keys:
            assert (np.isnan(j[k]) and np.isnan(t[k])) or j[k] == t[k], (k, j, t)
    assert jsc.eval_at == tsc.eval_at
    assert jsc.saved_at == tsc.saved_at and jsc.saved_at[-1] == thist[-1]["steps"]
    warm = algo_args["train"]["warmup_steps"]
    assert thist[-1]["steps"] == warm + total_blocks * INTERVAL * B
    # the records' series is every block's episodes since the last record
    # that saw one, the first records nan
    acc, want, last = [0.0, 0.0], [], float("nan")
    for b in range(1, total_blocks + 1):
        acc[0] += float(tsc.sums[b - 1])
        acc[1] += float(tsc.counts[b - 1])
        if b % blocks_per_eval == 0 or b == total_blocks:
            if acc[1] > 0:
                last, acc = acc[0] / acc[1], [0.0, 0.0]
            want.append(last)
    np.testing.assert_array_equal([r["mean_episode_return"] for r in thist], want)
    assert np.isnan(want[0])
