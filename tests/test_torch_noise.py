"""The port's production draws (``utils/noise.py`` ``GeneratorNoise``, and
``parallel/mesh.py`` ``ShardedNoise`` over it) against ``jax.random``, for
every draw HASAC takes at run time.

The replay tests swap these draws for the JAX package's, so they never see
the production source. Here each kind is held on its range and shape, its
moments against the distribution's at a z-score of at most ``Z`` at the
stated sample size, a two-sample Kolmogorov–Smirnov distance against
``jax.random``'s draws of the same kind below ``ks_bound`` (the distance two
samples of one distribution exceed with probability 1e-6), and the
independence of the draws a runner takes within an update (agent against
agent) and between updates: every correlation within ``Z / √n``. The
seeds are fixed, so the test is deterministic; a fault in a draw (a wrong
scale or shift, a half-open range closed, a draw repeated across agents)
lands many z away.
"""
import copy
import math

import jax
import numpy as np
import pytest
import torch

from harl_tpu.algos.off_policy_actors import HASACActor as JHASACActor
from harl_tpu.runners.off_policy import OffPolicyRunner as JRunner
from harl_tpu.utils.config_tools import get_defaults_yaml_args as jdefaults
from harl_tpu.utils.spaces import Box as JBox
from harl_tpu_torch.algos.off_policy_actors import HASACActor
from harl_tpu_torch.parallel.mesh import LOCAL, Mesh, ShardedNoise
from harl_tpu_torch.runners.off_policy import OffPolicyRunner
from harl_tpu_torch.utils.noise import GeneratorNoise
from harl_tpu_torch.utils.spaces import Box

from chip_smoke import RecordedNoise

Z = 5.0                 # z-score bound of every moment and correlation
N = 200_000             # draws of each kind held against its distribution


def ks_bound(n: int, m: int) -> float:
    """The two-sample KS distance exceeded with probability 1e-6."""
    return math.sqrt(-0.5 * math.log(1e-6 / 2)) * math.sqrt((n + m) / (n * m))


def ks(a, b) -> float:
    a, b = np.sort(np.ravel(a)), np.sort(np.ravel(b))
    grid = np.concatenate([a, b])
    return float(np.max(np.abs(np.searchsorted(a, grid, side="right") / a.size
                               - np.searchsorted(b, grid, side="right") / b.size)))


def source(seed=0):
    return GeneratorNoise(torch.Generator().manual_seed(seed), "cpu",
                          torch.Generator().manual_seed(seed))


def hold_moments(x, mean, var, what):
    """Sample mean and variance against the distribution's, each at most
    ``Z`` standard errors away (the variance's error from the fourth
    central moment)."""
    x = np.asarray(x, np.float64).ravel()
    n = x.size
    m4 = np.mean((x - mean) ** 4)
    assert abs(x.mean() - mean) <= Z * math.sqrt(var / n), (what, x.mean(), mean)
    assert abs(x.var() - var) <= Z * math.sqrt(max(m4 - var ** 2, 1e-12) / n), (what, x.var())


def test_uniform_on_zero_one():
    u = source().uniform((N,)).numpy()
    ju = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (N,)))
    for x, who in ((u, "port"), (ju, "jax")):
        assert x.dtype == np.float32 and x.shape == (N,)
        assert x.min() >= 0.0 and x.max() < 1.0, who
        hold_moments(x, 0.5, 1 / 12, who)
    assert ks(u, ju) <= ks_bound(N, N)
    assert source().uniform((3, 5)).shape == (3, 5)


@pytest.mark.parametrize("low,high", [([-1.0], [1.0]), ([-2.0, 0.0, 0.25], [3.0, 0.5, 0.75])])
def test_warmup_actions_map_onto_the_action_bounds(low, high):
    """``random_actions`` of the port's HASAC actor (the draw of both the
    pure-tensor warmup and the host warmup) against the JAX actor's
    ``jax.random.uniform(minval=low, maxval=high)``, and the same bits
    mapped alike."""
    space = Box(tuple(low), tuple(high))
    cfg = dict(hidden_sizes=[8], activation_func="relu", final_activation_func="tanh", lr=1e-3,
               polyak=0.005)
    actor = HASACActor(3, space, cfg, "cpu")
    jactor = JHASACActor(3, JBox(tuple(low), tuple(high)), cfg)
    n = N // len(low)
    a = actor.random_actions(source(), n).numpy()
    ja = np.asarray(jactor.random_actions(jax.random.PRNGKey(1), n))
    lo, hi = np.array(low, np.float32), np.array(high, np.float32)
    for x, who in ((a, "port"), (ja, "jax")):
        assert x.shape == (n, len(low)) and x.dtype == np.float32
        assert (x >= lo).all() and (x < hi).all(), who
        for d in range(len(low)):
            hold_moments(x[:, d], (lo[d] + hi[d]) / 2, (hi[d] - lo[d]) ** 2 / 12, f"{who} {d}")
    for d in range(len(low)):
        assert ks(a[:, d], ja[:, d]) <= ks_bound(n, n)

    class Bits:            # the JAX draw's bits on [0, 1), mapped by the port
        def uniform(self, shape):
            return torch.from_numpy(np.array(jax.random.uniform(jax.random.PRNGKey(1), shape)))

    mapped = actor.random_actions(Bits(), n).numpy()
    if low == [-1.0]:      # HalfCheetah's bounds: u·2 is exact, one rounding either way
        np.testing.assert_array_equal(mapped, ja)
    else:
        # XLA's CPU backend fuses u·(high − low) + low into one rounding
        # and the port rounds the product and the sum (ROADMAP Queue C):
        # apart by at most a rounding at the product's scale
        u = Bits().uniform((n, len(low))).numpy().astype(np.float64)
        np.testing.assert_array_equal(ja, (u * (hi - lo) + lo).astype(np.float32))
        assert (np.abs(mapped - ja) <= np.spacing(hi - lo)).all()


def test_action_noise_is_standard_normal():
    x = source().action_noise((N // 4, 4)).numpy()
    jx = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (N // 4, 4)))
    for v, who in ((x, "port"), (jx, "jax")):
        assert v.shape == (N // 4, 4) and v.dtype == np.float32 and np.isfinite(v).all()
        hold_moments(v, 0.0, 1.0, who)
        z = v.ravel().astype(np.float64)
        # skewness and excess kurtosis: standard errors √(6/n) and √(24/n)
        assert abs(np.mean(z ** 3)) <= Z * math.sqrt(6 / z.size), who
        assert abs(np.mean(z ** 4) - 3) <= Z * math.sqrt(96 / z.size), who
    assert ks(x, jx) <= ks_bound(N, N)


@pytest.mark.parametrize("high", [1, 7, 1000, 410_000])
def test_replay_indices_cover_zero_to_high(high):
    """``indices(batch, cur_size)``: the replay starts, with replacement."""
    noise, n = source(3), 1000
    x = np.concatenate([noise.indices(n, high).numpy() for _ in range(N // n)])
    jx = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (N,), 0, high))
    for v, who in ((x, "port"), (jx, "jax")):
        assert v.min() >= 0 and v.max() < high, who
        if high == 1:
            continue
        hold_moments(v, (high - 1) / 2, (high ** 2 - 1) / 12, who)
        bins = min(high, 100)
        counts = np.bincount(v * bins // high, minlength=bins)
        p = np.array([len(range(math.ceil(b * high / bins), math.ceil((b + 1) * high / bins)))
                      for b in range(bins)]) / high
        sd = np.sqrt(N * p * (1 - p))
        assert (np.abs(counts - N * p) <= Z * sd).all(), who
    assert x.dtype == np.int64 and source().indices(5, 9).shape == (5,)
    if high > 1:
        assert ks(x / high, jx / high) <= ks_bound(N, N)


def test_permutations_are_uniform_over_orders():
    """The agent order of an update (6 agents: 720 orders), drawn on the
    host generator; every element's place uniform and every order seen."""
    noise, M, n = source(4), 30_000, 6
    perms = np.stack([noise.permutation(n).numpy() for _ in range(M)])
    keys = jax.random.split(jax.random.PRNGKey(4), M)
    jperms = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, n))(keys))
    for p, who in ((perms, "port"), (jperms, "jax")):
        assert (np.sort(p, axis=1) == np.arange(n)).all(), who
        counts = np.stack([(p == e).sum(axis=0) for e in range(n)])      # element × place
        assert (np.abs(counts - M / n) <= Z * math.sqrt(M / n * (1 - 1 / n))).all(), who
        codes = p @ (n ** np.arange(n))
        assert len(np.unique(codes)) == math.factorial(n), who
    assert noise.permutation(n).device.type == "cpu"


def test_sharded_draws_are_the_global_draws_cut():
    """``ShardedNoise`` on each of two ranks: the env- and sample-axis draws
    are the one-rank draw's rows of the rank, replay starts and orders the
    same on every rank, and over ``LOCAL`` the base's draws themselves."""
    rows = 10
    one = source(5)
    ref = [one.uniform((rows, 3)), one.action_noise((rows, 2)), one.indices(7, 50),
           one.permutation(6), one.randint((rows, 1), 4)]
    cuts = []
    for r in range(2):
        sh = ShardedNoise(source(5), Mesh(r, 2, grouped=False), rows)
        cuts.append([sh.uniform((5, 3)), sh.action_noise((5, 2)), sh.indices(7, 50),
                     sh.permutation(6), sh.randint((5, 1), 4)])
        with pytest.raises(ValueError):
            sh.action_noise((rows, 2))
    for k in (0, 1, 4):
        assert torch.equal(torch.cat([cuts[0][k], cuts[1][k]]), ref[k])
    for k in (2, 3):
        assert torch.equal(cuts[0][k], ref[k]) and torch.equal(cuts[1][k], ref[k])
    local = ShardedNoise(source(5), LOCAL, rows)
    got = [local.uniform((rows, 3)), local.action_noise((rows, 2)), local.indices(7, 50)]
    for g, want in zip(got, ref):
        assert torch.equal(g, want)
    hold_moments(ShardedNoise(source(6), LOCAL, N).uniform((N,)).numpy(), 0.5, 1 / 12, "local")


def _hasac(noise, batch):
    algo_args, env_args = jdefaults("hasac", "mamujoco_jax")
    algo_args["train"].update(n_rollout_threads=8, warmup_steps=64, train_interval=2,
                              update_per_train=1, num_env_steps=10 ** 6)
    algo_args["algo"].update(batch_size=batch, buffer_size=200, n_step=3, auto_alpha=True)
    algo_args["model"].update(hidden_sizes=[8, 8])
    env_args.update(scenario="HalfCheetah-v2", agent_conf="6x1", episode_limit=20)
    return algo_args, env_args


def _corr_bound(x, y):
    x, y = np.ravel(x).astype(np.float64), np.ravel(y).astype(np.float64)
    return abs(np.corrcoef(x, y)[0, 1]), Z / math.sqrt(x.size)


def test_a_runner_s_draws_are_independent_within_and_between_updates():
    """The draws of two HASAC updates of the port's runner (6 agents of one
    joint, batch 4096) through the production source: within an update
    the next-action, initial-action and update-order normals of every agent
    pair, and between the updates each agent's, uncorrelated; the replay
    starts of the two updates too. The JAX runner's ``fold_in`` draws of one
    update, for scale, likewise."""
    batch = 4096
    algo_args, env_args = _hasac(None, batch)
    rec = RecordedNoise(GeneratorNoise(torch.Generator().manual_seed(7), "cpu",
                                       torch.Generator().manual_seed(7)))
    args = {"algo": "hasac", "env": "mamujoco_jax", "exp_name": "noise"}
    runner = OffPolicyRunner(args, copy.deepcopy(algo_args), env_args, device="cpu", noise=rec)
    state = runner.warmup_block(runner.init_state(0))
    rec.log.clear()
    for _ in range(2):
        runner.update(state)
    kinds = [k for k, _, _ in rec.log]
    # per update: starts, 6 next-action, 6 initial-action normals, the order,
    # 6 update-order normals
    assert kinds == (["indices"] + ["action_noise"] * 12 + ["permutation"]
                     + ["action_noise"] * 6) * 2
    updates = [rec.log[:20], rec.log[20:]]
    for up in updates:
        normals = [out.numpy() for k, _, out in up if k == "action_noise"]
        assert all(x.shape == (batch, 1) for x in normals)
        for i in range(len(normals)):
            for j in range(i + 1, len(normals)):
                r, bound = _corr_bound(normals[i], normals[j])
                assert r <= bound, (i, j, r)
        hold_moments(np.concatenate(normals), 0.0, 1.0, "update normals")
    for a, b in zip(updates[0], updates[1]):
        r, bound = _corr_bound(a[2].numpy(), b[2].numpy())
        assert r <= bound, (a[0], r)
    jr = JRunner(args, copy.deepcopy(algo_args), env_args)
    k = jax.random.split(jax.random.PRNGKey(7), 5)
    jn = [np.asarray(jax.random.normal(jax.random.fold_in(k[2], i), (batch, 1)))
          for i in list(range(6)) + [100 + i for i in range(6)]]
    for i in range(len(jn)):
        for j in range(i + 1, len(jn)):
            r, bound = _corr_bound(jn[i], jn[j])
            assert r <= bound
    assert jr.n_agents == runner.n_agents == 6
