"""Port parity: SMACv2's randomized maps on SMACLite against the JAX env.

The port's reset takes the JAX reset's draws, re-derived from the same keys
(``tests/torch_replay.py``): the weighted team draws, the spawn branch, the
reflected and surrounded spawns. Types are held exactly and positions at
rtol 1e-5 / atol 1e-6 (XLA's float32 ring cos/sin differs from the port's
by an ulp now and then). Steps start from the same JAX state and are held
exactly on everything discrete and at the SMACLite tolerances on floats
(``tests/test_torch_smaclite.py``), through episode ends and their
auto-resets. The spaces and capability configs equal the JAX package's for
all 15 map YAMLs, and the port's YAMLs are byte copies of the JAX ones.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harl_tpu.envs.core import VecEnv as JVecEnv
from harl_tpu.envs.smaclite import smaclite as jsmac
from harl_tpu_torch.envs import make_env
from harl_tpu_torch.envs.core import auto_reset_step
from harl_tpu_torch.envs.smaclite import smaclite as tsmac

from tests.torch_replay import smacv2_reset_noise, step_smacv2_reset_noise
from tests.test_torch_smaclite import (_check_state, _check_ts, _close, _port_state,
                                       _random_available, _same)

ROOT = Path(__file__).resolve().parents[1]
JAX_CFGS = ROOT / "harl_tpu" / "configs" / "envs_cfgs"
PORT_CFGS = ROOT / "harl_tpu_torch" / "configs" / "envs_cfgs"
V2_MAPS = sorted(p.stem for p in (JAX_CFGS / "smacv2_map_config").glob("*.yaml"))
X = 16
# a reset key whose ally team draws five medivacs (found by a search over
# PRNGKey(i)): the exception rule turns unit 0 into a marine, the first
# of the heaviest non-exception types
ALL_MEDIVAC_KEY = 52598
MAPS = [("protoss_5_vs_5", "EP"), ("terran_5_vs_5", "FP"), ("zerg_10_vs_11", "EP")]


def _envs(name, state_type="EP", **kw):
    return (jsmac.make_smaclite(name, state_type=state_type, **kw),
            tsmac.make_smaclite(name, torch.device("cpu"), state_type=state_type, **kw))


def _keys(seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), X - 1)
    return jnp.concatenate([keys, jax.random.PRNGKey(ALL_MEDIVAC_KEY)[None]])


@pytest.mark.parametrize("name,state_type", MAPS)
def test_reset_and_steps_match_jax(name, state_type):
    """A reset from replayed draws, then 30 steps with random available
    actions, each taken by both sides from the same JAX state through the
    auto-reset of 8-step episodes (``VecEnv.step``)."""
    jenv, tenv = _envs(name, state_type, episode_limit=8)
    keys = _keys(4)
    jstate, jts = jax.jit(jax.vmap(jenv.reset))(keys)
    noise = smacv2_reset_noise(keys, tenv.n_allies, tenv.n_enemies)
    assert [tuple(x.shape) for x in noise] == [(X, w) for _, w in tenv.reset_noise_spec]
    tstate, tts = tenv.reset(noise)
    _check_state(tstate, jstate)
    _check_ts(tts, jts, state_type)
    # both spawn branches, and teams that differ across envs
    surround = noise[2][:, 0] < tenv.surround_p
    assert bool(surround.any()) and bool((~surround).any())
    assert len({tuple(t) for t in tstate.ally_type.tolist()}) > 1
    pool = set(tenv.race_pool)
    assert set(tstate.ally_type.unique().tolist()) <= pool
    if name.startswith("terran"):
        # the exception rule: the all-medivac draw of the last env
        assert tstate.ally_type[-1].tolist() == [jsmac.MARINE] + [jsmac.MEDIVAC] * 4
        assert bool((tstate.ally_type == jsmac.MEDIVAC).any(dim=1)[:-1].any())
    if name.startswith("zerg"):
        assert bool((tstate.enemy_type == jsmac.BANELING).any())

    vec = JVecEnv(jenv, X)
    jstep = jax.jit(vec.step)
    rng = np.random.default_rng(0)
    ends = 0
    for step in range(30):
        a = _random_available(rng, jts.available_actions)
        k_env = jax.random.PRNGKey(100 + step)
        jtr = jstep(jstate, jnp.asarray(a), k_env)
        ttr = auto_reset_step(tenv, _port_state(jstate), torch.from_numpy(a),
                              step_smacv2_reset_noise(k_env, X, tenv.n_allies, tenv.n_enemies))
        _check_state(ttr.state, jtr.state)
        _check_ts(ttr.ts, jtr.ts, state_type)
        _check_ts(ttr.final, jtr.final, state_type)
        ends += int(np.asarray(jtr.final.dones).all(axis=1).sum())
        jstate, jts = jtr.state, jtr.ts
    assert ends >= X      # every env ended an episode and was reset


@pytest.mark.parametrize("name", V2_MAPS + ["terran_7_vs_9"])
def test_spaces_and_map_configs_match_jax(name):
    """Every SMACv2 YAML (and one name of the ``<race>_<A>_vs_<E>`` form):
    the capability config, team sizes, widths of obs, EP and FP states,
    actions, the reward scale and the mechanics flags."""
    assert tsmac.load_smacv2_map_config(name) == jsmac.load_smacv2_map_config(name)
    for state_type in ("EP", "FP"):
        jenv, tenv = _envs(name, state_type)
        assert tenv.randomize_types and tenv.episode_limit == jenv.episode_limit == 150
        assert (tenv.n_allies, tenv.n_enemies, tenv.n_actions, tenv._bits) == (
            jenv.n_allies, jenv.n_enemies, jenv.n_actions, jenv._bits)
        assert (tenv.obs_dim, tenv.state_dim, tenv.fp_state_dim) == (
            jenv.obs_dim, jenv.state_dim, jenv.fp_state_dim)
        assert tenv.share_observation_space[0].shape == jenv.share_observation_space[0].shape
        assert tenv.max_reward == jenv.max_reward
        assert (tenv.race_pool, tenv.race_weights, tenv.exception_types, tenv.surround_p) == (
            jenv.race_pool, jenv.race_weights, jenv.exception_types, jenv.surround_p)
        assert tenv.ally_med == (jsmac.MEDIVAC in jenv.race_pool)
        assert tenv.ally_bane == (jsmac.BANELING in jenv.race_pool)
        for t, j in zip((tenv.loc_a, tenv.loc_e), jenv._locals):
            _same(t, j)


@pytest.mark.parametrize("rel", ["smac.yaml", "smacv2.yaml"]
                         + [f"smacv2_map_config/{m}.yaml" for m in V2_MAPS])
def test_port_yamls_are_byte_copies(rel):
    assert (PORT_CFGS / rel).read_bytes() == (JAX_CFGS / rel).read_bytes()


def test_make_env_routes_smac_and_smacv2():
    for env_name in ("smac", "smacv2"):
        env = make_env(env_name, {"map_name": "zerg_10_vs_11", "state_type": "FP",
                                  "episode_limit": 40, "reward_scale": False}, device="cpu")
        assert env.randomize_types and env.n_agents == 10 and env.n_enemies == 11
        assert (env.state_type, env.episode_limit, env.reward_scale) == ("FP", 40, False)
        # the real game: its adapter, whose package is missing here
        with pytest.raises(ImportError, match="StarCraft II"):
            make_env(env_name, {"map_name": "3m", "backend": "native"}, device="cpu")
    fixed = make_env("smac", {"map_name": "3m", "backend": "jax"}, device="cpu")
    assert not fixed.randomize_types and fixed.n_agents == 3
    state, ts = fixed.reset(tuple(torch.zeros((2, w)) for _, w in fixed.reset_noise_spec))
    _close(state.ally_pos[:, :, 0], torch.full((2, 3), -7.0))
