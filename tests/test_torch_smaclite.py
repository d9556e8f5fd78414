"""Port parity: SMACLite against the JAX env.

The JAX env is vmapped over a small batch of envs; the port steps the same
batch as one tensor. Single steps start from the same states (JAX states
copied into the port) and are held exactly on everything discrete (alive,
availability, dones, targets, last actions) and at rtol 1e-5 / atol 1e-6 on
floats. A 30-step trajectory then runs each side free from the same state
with the same fixed actions, and the scripted behaviour anchors of
``tests/test_smaclite.py`` run on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harl_tpu.envs.smaclite.smaclite import make_smaclite as jmake
from harl_tpu_torch.envs import make_env
from harl_tpu_torch.envs.core import auto_reset_step
from harl_tpu_torch.envs.smaclite.smaclite import N_MOVE_ACTIONS, SMACLiteState, make_smaclite

from tests.torch_replay import smaclite_reset_noise, step_smaclite_reset_noise

X = 6
RTOL, ATOL = 1e-5, 1e-6
MAPS = ["5m_vs_6m", "3m", "2s3z", "MMM", "bane_vs_bane"]
FLOAT_FIELDS = ("ally_pos", "ally_health", "ally_shield", "ally_cd", "ally_hit_t", "enemy_pos",
                "enemy_health", "enemy_shield", "enemy_cd", "enemy_hit_t")
EXACT_FIELDS = ("ally_type", "enemy_type", "last_action", "enemy_tgt", "t", "battle_over")


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _port_state(jstate) -> SMACLiteState:
    """A vmapped JAX state as the port's state tensors."""
    out = {k: torch.from_numpy(np.array(getattr(jstate, k))) for k in SMACLiteState._fields}
    for k in ("ally_type", "enemy_type", "enemy_tgt"):   # int32 in JAX, indices here
        out[k] = out[k].long()
    return SMACLiteState(**out)


def _check_state(tstate, jstate):
    for k in FLOAT_FIELDS:
        _close(getattr(tstate, k), getattr(jstate, k))
    for k in EXACT_FIELDS:
        _same(getattr(tstate, k), getattr(jstate, k))
    # alive is what every discrete output hangs on
    _same(tstate.ally_health > 0, np.asarray(jstate.ally_health) > 0)
    _same(tstate.enemy_health > 0, np.asarray(jstate.enemy_health) > 0)


def _check_ts(tts, jts, state_type):
    _close(tts.obs, jts.obs)
    _close(tts.share_obs, jts.share_obs)
    _close(tts.rewards, jts.rewards)
    _same(tts.dones, jts.dones)
    _same(tts.bad_transition, jts.bad_transition)
    _same(tts.available_actions, jts.available_actions)
    if state_type == "FP":
        _close(tts.agent_state, jts.agent_state)
    else:
        assert tts.agent_state is None
    for k, v in jts.metrics.items():
        _close(tts.metrics[k], v)


def _envs(map_name, state_type, **kw):
    return (jmake(map_name, state_type=state_type, **kw),
            make_smaclite(map_name, torch.device("cpu"), state_type=state_type, **kw))


def _jax_fns(jenv):
    reset = jax.jit(jax.vmap(jenv.reset))
    step = jax.jit(jax.vmap(lambda s, a: jenv.step(s, a, None)))
    return reset, step


def _random_available(rng, avail):
    """One available action per (env, agent), uniformly: (X, A, 1) int32."""
    avail = np.asarray(avail)
    u = rng.uniform(size=avail.shape) * avail
    return u.argmax(-1)[..., None].astype(np.int32)


@pytest.mark.parametrize("state_type", ["EP", "FP"])
@pytest.mark.parametrize("map_name", MAPS)
def test_reset_and_steps_match_jax(map_name, state_type):
    """Reset from replayed draws, then 12 single steps each taken by both
    sides from the same JAX state with random available actions."""
    jenv, tenv = _envs(map_name, state_type, episode_limit=10)
    jreset, jstep = _jax_fns(jenv)
    keys = jax.random.split(jax.random.PRNGKey(11), X)
    jstate, jts = jreset(keys)
    tstate, tts = tenv.reset(smaclite_reset_noise(keys, tenv.n_allies, tenv.n_enemies))
    _check_state(tstate, jstate)
    _check_ts(tts, jts, state_type)
    assert tenv.obs_dim == jenv.obs_dim and tenv.state_dim == jenv.state_dim
    assert tenv.fp_state_dim == jenv.fp_state_dim and tenv.n_actions == jenv.n_actions

    rng = np.random.default_rng(0)
    seen_dead = seen_fire = False
    for _ in range(12):
        a = _random_available(rng, jts.available_actions)
        jnext, jts = jstep(jstate, jnp.asarray(a))
        tnext, tts = tenv.step(_port_state(jstate), torch.from_numpy(a))
        _check_state(tnext, jnext)
        _check_ts(tts, jts, state_type)
        seen_dead |= bool((np.asarray(jnext.ally_health) <= 0).any()
                          or (np.asarray(jnext.enemy_health) <= 0).any())
        seen_fire |= bool((np.asarray(jnext.ally_cd) > 0).any())
        jstate = jnext
    assert seen_fire
    if map_name in ("bane_vs_bane", "3m", "5m_vs_6m"):
        assert seen_dead


@pytest.mark.parametrize("map_name", ["5m_vs_6m", "2s3z", "MMM"])
def test_free_trajectory_matches_jax(map_name):
    """30 steps from one state with the same fixed (state-independent)
    actions, each side on its own state: the episode limit truncates and
    units die on the way."""
    jenv, tenv = _envs(map_name, "FP", episode_limit=25)
    jreset, jstep = _jax_fns(jenv)
    keys = jax.random.split(jax.random.PRNGKey(5), X)
    jstate, _ = jreset(keys)
    tstate = _port_state(jstate)
    rng = np.random.default_rng(1)
    # mostly attacks on random enemies, some moves and stops
    for _ in range(30):
        a = np.where(rng.uniform(size=(X, tenv.n_allies, 1)) < 0.7,
                     rng.integers(N_MOVE_ACTIONS, tenv.n_actions, size=(X, tenv.n_allies, 1)),
                     rng.integers(1, N_MOVE_ACTIONS, size=(X, tenv.n_allies, 1))).astype(np.int32)
        jstate, jts = jstep(jstate, jnp.asarray(a))
        tstate, tts = tenv.step(tstate, torch.from_numpy(a))
        _check_state(tstate, jstate)
        _check_ts(tts, jts, "FP")
    assert int(np.asarray(jstate.t).min()) == 30
    assert bool((np.asarray(jstate.ally_health) <= 0).any())


def test_auto_reset_step_matches_jax():
    """A finishing step returns the fresh episode's obs, FP state and
    availability, and the finishing step's rewards, dones and metrics."""
    jenv, tenv = _envs("3m", "FP", episode_limit=3)
    jreset, _ = _jax_fns(jenv)
    jstate, _ = jreset(jax.random.split(jax.random.PRNGKey(2), X))
    jstate = jstate._replace(t=jnp.asarray(np.array([0, 2] * (X // 2), np.int32)))
    a = np.ones((X, 3, 1), np.int32)
    k_env = jax.random.PRNGKey(9)
    from harl_tpu.envs.core import VecEnv as JVecEnv

    jtr = JVecEnv(jenv, X).step(jstate, jnp.asarray(a), k_env)
    ttr = auto_reset_step(tenv, _port_state(jstate), torch.from_numpy(a),
                          step_smaclite_reset_noise(k_env, X, 3, 3))
    _check_state(ttr.state, jtr.state)
    _check_ts(ttr.ts, jtr.ts, "FP")
    _check_ts(ttr.final, jtr.final, "FP")
    assert ttr.ts.dones[:, 0].tolist() == [False, True] * (X // 2)
    assert ttr.state.t.tolist() == [1, 0] * (X // 2)


# ------------------------------------------- scripted behaviour, on the port
def _focus_fire(tstate):
    """All allies attack the lowest-health living enemy (stop if none)."""
    hp = tstate.enemy_health
    tgt = torch.where(hp > 0, hp, 1e9).argmin(dim=1)
    a = torch.where((hp > 0).any(dim=1), N_MOVE_ACTIONS + tgt, 1)
    return a[:, None, None].expand(-1, tstate.ally_health.shape[1], 1)


def _play(map_name, policy, n_seeds=8, limit=None, steps=200):
    """``n_seeds`` episodes at once from the JAX package's reset keys
    PRNGKey(0..n−1); returns (won per episode, final state)."""
    tenv = make_env("smaclite", {"map_name": map_name, "episode_limit": limit}
                    if limit else {"map_name": map_name}, device="cpu")
    keys = jnp.stack([jax.random.PRNGKey(s) for s in range(n_seeds)])
    state, _ = tenv.reset(smaclite_reset_noise(keys, tenv.n_allies, tenv.n_enemies))
    won = torch.zeros(n_seeds)
    finished = torch.zeros(n_seeds, dtype=torch.bool)
    for _ in range(steps):
        state, ts = tenv.step(state, policy(state))
        done = ts.dones.all(dim=1)
        won = torch.where(done & ~finished, ts.metrics["won"], won)
        finished |= done
        if bool(finished.all()):
            break
    return won, state


def test_enemy_bot_beats_passive_allies():
    """Allies that only stop are wiped out on 5m_vs_6m without a kill
    (test_smaclite.py:438-452, one episode)."""
    won, state = _play("5m_vs_6m", lambda s: torch.ones((1, 5, 1), dtype=torch.int32),
                       n_seeds=1, limit=70, steps=70)
    assert bool((state.ally_health <= 0).all())
    assert bool((state.enemy_health > 0).all())
    assert float(won.sum()) == 0.0


def test_focus_fire_no_micro_loses_5m_vs_6m():
    won, _ = _play("5m_vs_6m", _focus_fire)
    assert float(won.mean()) < 0.05, f"no-micro focus fire won {float(won.sum())}/8"


def test_focus_fire_wins_mirror_5m_vs_5m():
    won, _ = _play("5m_vs_5m", _focus_fire)
    assert float(won.mean()) >= 0.5, f"focus fire won only {float(won.sum())}/8"


def test_registry_and_unported_names():
    env = make_env("smaclite", {"map_name": "5m_vs_6m", "state_type": "FP"}, device="cpu")
    # the bench's widths (bench.py:257-268)
    assert (env.obs_dim, env.state_dim, env.fp_state_dim, env.n_actions) == (124, 244, 156, 12)
    assert env.episode_limit == 70 and env.reset_noise_dim == 22
    generic = make_smaclite("7m_vs_9m")
    assert (generic.n_allies, generic.n_enemies, generic.episode_limit) == (7, 9, 100)
    # SMACv2's randomized maps and the smac env name, refused before, build
    # (their parity with JAX is in test_torch_smacv2.py)
    for name, sizes in (("protoss_5_vs_5", (5, 5)), ("terran_10_vs_11", (10, 11)),
                        ("zerg_5_vs_5", (5, 5))):
        env = make_smaclite(name)
        assert env.randomize_types and (env.n_allies, env.n_enemies) == sizes
    assert make_env("smac", {}, device="cpu").n_agents == 5
    # the real game: its adapter, whose package is missing here
    with pytest.raises(ImportError, match="StarCraft II"):
        make_env("smac", {"backend": "native"}, device="cpu")
