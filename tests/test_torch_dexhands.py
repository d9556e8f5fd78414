"""Port parity: the Bi-DexterousHands catch family
(``envs/dexhands_jax/handover.py``) against the JAX env, and the spaces and
routing of all 25 tasks (the steps of the Allegro and Meta layouts are in
``tests/test_torch_dexhands_meta.py``, the manipulation family's in
``tests/test_torch_dexhands_manip.py``).

Each catch task resets from the JAX draws (``tests/torch_replay.py``) and
runs 4 env steps of random actions on both sides, each on its own state;
the states, observations and rewards are held at rtol 1e-4 / atol 1e-5 and
``won``, dones and bad masks are equal. The rotation angle 2·arccos|⟨a, b⟩|
moves by ~1e-3 rad for one float32 ulp of ⟨a, b⟩ near 1, so it is held at
atol 2e-3 on its own; ReOrientation's success (angle < 0.1) comes out equal.
The pads' velocities are held against ``jax.jvp`` of the finger kinematics
at rtol 1e-5 / atol 1e-6, from joints inside, outside and exactly at the
flexion limits, where ``jnp.clip``'s tangent is ½.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harl_tpu.envs.dexhands_jax import handover as jho
from harl_tpu.envs.dexhands_jax import manip as jma
from harl_tpu_torch.envs import make_env
from harl_tpu_torch.envs.core import auto_reset_step
from harl_tpu_torch.envs.dexhands_jax import handover as tho
from harl_tpu_torch.envs.dexhands_jax import manip as tma

from tests.torch_replay import _step_reset_keys, env_reset_noise

RTOL, ATOL = 1e-4, 1e-5
KIN_RTOL, KIN_ATOL = 1e-5, 1e-6
ROT_ATOL = 2e-3
X, STEPS = 8, 4
ALL_TASKS = tuple(jho.DEXHANDS_TASKS) + tuple(jma.DEXHANDS_MANIP_TASKS)


def _share(a, b, rtol=RTOL, atol=ATOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / (atol + rtol * np.abs(b))).max())


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _jax_env(task):
    make = jma.make_manip if task in jma.MANIP_TASKS else jho.make_handover
    return make({"task": task})


def _noise(env, keys):
    return tuple(torch.from_numpy(np.array(x)) for x in env_reset_noise(env, keys))


@functools.lru_cache(maxsize=None)
def jax_fns(task):
    """The JAX env's jitted, vmapped reset and step (compiled once a task)."""
    env = _jax_env(task)
    return (jax.jit(jax.vmap(env.reset)),
            jax.jit(jax.vmap(lambda s, a: env.step(s, a, None))))


def free_steps(task, seed=0):
    """Reset from the same draws and STEPS env steps of random actions on
    both sides; returns the worst share of the tolerance over the floats and
    the port's last timestep."""
    tenv = make_env("dexhands_jax", {"task": task}, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(seed), X)
    nj = tenv.action_space[0].shape[0]
    acts = np.random.default_rng(seed).uniform(-1.0, 1.0, (STEPS, X, 2, nj)).astype(np.float32)
    jreset, jstep = jax_fns(task)
    js, jts = jreset(keys)
    ts, tts = tenv.reset(_noise(tenv, keys))
    for t_, j_ in zip(ts, js):
        _close(t_, j_, KIN_RTOL, KIN_ATOL)
    _close(tts.obs, jts.obs, KIN_RTOL, KIN_ATOL)
    worst = 0.0
    for i in range(STEPS):
        ts, tts = tenv.step(ts, torch.from_numpy(acts[i]))
        js, jts = jstep(js, jnp.asarray(acts[i]))
        js, jts = jax.tree.map(np.asarray, (js, jts))
        for name, t_ in ts._asdict().items():
            j_ = getattr(js, name)
            if t_.dtype in (torch.bool, torch.int32):
                np.testing.assert_array_equal(t_.numpy(), j_, err_msg=name)
            else:
                worst = max(worst, _share(t_, j_))
        for t_, j_ in ((tts.obs, jts.obs), (tts.share_obs, jts.share_obs),
                       (tts.rewards, jts.rewards)):
            worst = max(worst, _share(t_, j_))
        np.testing.assert_array_equal(tts.dones.numpy(), jts.dones)
        np.testing.assert_array_equal(tts.bad_transition.numpy(), jts.bad_transition)
        np.testing.assert_array_equal(tts.metrics["won"].numpy(), jts.metrics["won"])
    return worst, ts, tts, js


@pytest.mark.parametrize("task", ALL_TASKS)
def test_spaces_match_jax(task):
    jenv = _jax_env(task)
    tenv = make_env("dexhands_jax", {"task": task}, device="cpu")
    assert type(tenv).__name__ == type(jenv).__name__ and tenv.n_agents == jenv.n_agents == 2
    for t_sp, j_sp in ((tenv.action_space, jenv.action_space),
                       (tenv.observation_space, jenv.observation_space),
                       (tenv.share_observation_space, jenv.share_observation_space)):
        assert [s.shape for s in t_sp] == [s.shape for s in j_sp]
        assert [float(s.low[0]) for s in t_sp] == [float(s.low[0]) for s in j_sp]
    assert tenv.episode_length == jenv.episode_length
    assert tuple(tenv.metric_keys) == tuple(jenv.metric_keys) == ("won",)
    if task in jma.MANIP_TASKS:
        assert tenv.reset_noise_spec == (("normal", 1 if jenv.is_hinge else 3 * jenv.n_obj),)
    else:
        n = jenv.n_objects
        assert tenv.reset_noise_spec == (("randint", 1, len(jenv._layout_names)),
                                         ("normal", 3 * n), ("normal", 3 * n),
                                         ("normal", 3 * n), ("uniform", n))


def test_routing_and_episode_length():
    """``dexhands`` runs the tensor hands unless the native IsaacGym backend
    is asked for; the horizon comes from ``hands_episode_length``."""
    env = make_env("dexhands", {"task": "ShadowHandPen", "hands_episode_length": 30},
                   device="cpu")
    assert isinstance(env, tma.ShadowHandManip) and env.episode_length == 30
    env = make_env("dexhands", {"task": "AllegroHandOver", "backend": "jax"}, device="cpu")
    assert isinstance(env, tho.ShadowHandOver) and env.n_joints == 16
    assert make_env("dexhands_jax", {}, device="cpu").task == "ShadowHandOver"
    with pytest.raises(NotImplementedError, match="ROADMAP.md, tooling"):
        make_env("dexhands", {"task": "ShadowHandOver", "backend": "native"}, device="cpu")
    with pytest.raises(ValueError, match="available"):
        make_env("dexhands_jax", {"task": "ShadowHandJuggle"}, device="cpu")


SHADOW_CATCH = tuple(t for t in jho.DEXHANDS_TASKS if t.startswith("ShadowHand")
                     and "Meta" not in t)


@pytest.mark.parametrize("task", SHADOW_CATCH)
def test_catch_tasks_reset_and_step_like_jax(task):
    worst, ts, tts, js = free_steps(task)
    print(f"{task}: worst element over {STEPS} steps {worst:.3f} of the tolerance")
    assert worst <= 1.0
    rot_t = tho.quat_angle(ts.obj_quat, ts.goal_quat).numpy()
    rot_j = np.asarray(jho._quat_angle(js.obj_quat, js.goal_quat))
    _close(rot_t, rot_j, 0.0, ROT_ATOL)
    np.testing.assert_array_equal(rot_t < 0.1, rot_j < 0.1)


@functools.lru_cache(maxsize=None)
def _jax_pads(n_fingers):
    def one(theta, theta_dot, pos, fwd, up):
        return jax.jvp(lambda th: jho._hand_contact_points(th, pos, fwd, up), (theta,),
                       (theta_dot,))

    return jax.jit(jax.vmap(one))


@pytest.mark.parametrize("n_fingers", [5, 4])
def test_pad_velocities_match_jvp_at_the_limits(n_fingers):
    """Joints inside, outside and exactly at FLEX_LO and FLEX_HI (as the
    servo's clip leaves them): the port's written-out derivative equals
    ``jax.jvp``, including the ½ of ``jnp.clip``'s tangent at a bound."""
    rng = np.random.default_rng(n_fingers)
    n, nj = 16, 4 * n_fingers
    theta = rng.uniform(-0.5, 2.0, (n, nj)).astype(np.float32)
    flex = np.ones(nj, bool)
    flex[::4] = False
    pick = rng.integers(0, 4, (n, nj))
    theta = np.where(flex & (pick == 0), np.float32(jho.FLEX_LO), theta)
    theta = np.where(flex & (pick == 1), np.float32(jho.FLEX_HI), theta)
    theta_dot = rng.normal(0.0, 5.0, (n, nj)).astype(np.float32)
    pos = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    fwd = rng.choice([-1.0, 1.0], n).astype(np.float32)
    up = rng.choice([-1.0, 1.0], n).astype(np.float32)
    jp, jv = _jax_pads(n_fingers)(theta, theta_dot, pos, fwd, up)
    t = lambda x: torch.from_numpy(x)
    hands = tho.HandKinematics(n_fingers, torch.device("cpu"))
    base = hands.bases(t(pos), t(fwd))
    tp, tv = hands.points(t(theta), base, t(fwd), t(up), t(theta_dot))
    _close(tp.reshape(n, -1, 3), jp, KIN_RTOL, KIN_ATOL)
    _close(tv.reshape(n, -1, 3), jv, KIN_RTOL, KIN_ATOL)
    # the ½ rule matters: with the inclusive mask the velocities differ
    at = torch.from_numpy(flex & (pick < 2)).float()
    assert int(at.sum()) > 10
    _, tv_one = hands.points(t(theta), base, t(fwd), t(up), t(theta_dot) * (1 + at))
    assert not np.allclose(tv_one.reshape(n, -1, 3).numpy(), np.asarray(jv), atol=1e-3)


def test_substep_from_joints_past_the_limits_matches_jax():
    """The servo's targets stay inside the flexion range (at most 1.6999999
    in float32), so the servo itself never clips a flexion joint; a joint
    past a limit (a restored or perturbed state) is clipped to exactly the
    limit in one substep, and the pads then move at ½ of its rate in JAX.
    A substep from such a state, with the object resting in the fingers,
    matches the JAX substep."""
    tenv = make_env("dexhands_jax", {"task": "ShadowHandOver"}, device="cpu")
    jenv = _jax_env("ShadowHandOver")
    keys = jax.random.split(jax.random.PRNGKey(6), 8)
    ts, _ = tenv.reset(_noise(tenv, keys))
    rng = np.random.default_rng(6)
    theta = rng.uniform(-0.3, 1.8, (8, 2, 20)).astype(np.float32)
    theta[:, :, 1::4] = 1.75                     # past FLEX_HI
    theta[:, :, 2::4] = -0.25                    # past FLEX_LO
    tgt = tho.servo_targets(torch.from_numpy(rng.uniform(-1, 1, (8, 2, 20)).astype(np.float32)),
                            5)
    new = tho.servo(torch.from_numpy(theta), tgt, 5)
    assert (new[..., 1::4] == np.float32(jho.FLEX_HI)).all()
    assert (new[..., 2::4] == np.float32(jho.FLEX_LO)).all()
    pos = ts.obj_pos.clone()
    pos[:, 0, 1] += 0.03                          # among the thrower's fingers
    ts = ts._replace(theta=torch.from_numpy(theta), obj_pos=pos)
    hp, fw, up = tenv._hands(ts.layout)
    out_t = tenv._substep(ts.theta, tgt, ts.obj_pos, ts.obj_quat, ts.obj_vel, ts.obj_omg,
                          tenv.hands.bases(hp, fw), hp, fw, up)
    out_j = jax.jit(jax.vmap(jenv._substep))(*(jnp.asarray(x.numpy()) for x in (
        ts.theta, tgt, ts.obj_pos, ts.obj_quat, ts.obj_vel, ts.obj_omg, hp, fw, up)))
    for a, b in zip(out_t, out_j):
        _close(a, b, KIN_RTOL, KIN_ATOL)
    assert float(torch.linalg.vector_norm(out_t[3] - ts.obj_vel, dim=-1).max()) > 0.05


def test_two_catch_sphere_contact_matches_jax():
    """Two objects overlapping and approaching: the frictionless pair force
    and a whole substep from that state."""
    rng = np.random.default_rng(3)
    p0 = rng.uniform(-0.1, 0.1, (8, 3)).astype(np.float32)
    p1 = (p0 + rng.uniform(-0.05, 0.05, (8, 3))).astype(np.float32)
    v0, v1 = (rng.normal(0, 1, (8, 3)).astype(np.float32) for _ in range(2))
    jenv = jho.make_handover({"task": "ShadowHandTwoCatchUnderarm"})
    jf = jax.vmap(jenv._sphere_contact)(p0, v0, p1, v1)
    t = lambda x: torch.from_numpy(x)
    tf = tho.ShadowHandOver._sphere_contact(t(p0), t(v0), t(p1), t(v1))
    _close(tf, jf, KIN_RTOL, KIN_ATOL)
    assert float(torch.linalg.vector_norm(tf, dim=-1).max()) > 1.0   # in contact
    # a substep with both objects in each other's way above the thrower
    tenv = make_env("dexhands_jax", {"task": "ShadowHandTwoCatchUnderarm"}, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(2), 8)
    ts, _ = tenv.reset(_noise(tenv, keys))
    pos = np.stack([np.array([0.0, 0.05, 0.05]) + 0 * p0, np.array([0.0, 0.05, 0.05])
                    + np.array([0.06, 0.0, 0.0]) + 0.01 * p0], axis=1).astype(np.float32)
    vel = np.stack([v0, v1], axis=1)
    ts = ts._replace(obj_pos=t(pos), obj_vel=t(vel))
    tgt = tho.servo_targets(torch.zeros(8, 2, 20), 5)
    hp, fw, up = tenv._hands(ts.layout)
    out_t = tenv._substep(ts.theta, tgt, ts.obj_pos, ts.obj_quat, ts.obj_vel, ts.obj_omg,
                          tenv.hands.bases(hp, fw), hp, fw, up)
    out_j = jax.jit(jax.vmap(lambda th, p, q, v, w, h, f, u: jenv._substep(
        th, jnp.asarray(tgt[0].numpy()), p, q, v, w, h, f, u)))(
        *(jnp.asarray(x.numpy()) for x in (ts.theta, ts.obj_pos, ts.obj_quat, ts.obj_vel,
                                           ts.obj_omg, hp, fw, up)))
    for a, b in zip(out_t, out_j):
        _close(a, b, KIN_RTOL, KIN_ATOL)


def test_drop_terminates_and_the_limit_truncates_like_jax():
    """Through the auto-reset: an object below the drop height ends its
    episode (done, not bad), the last step of the horizon truncates (bad),
    success stays sticky and does not end the episode."""
    task = "ShadowHandOver"
    tenv = make_env("dexhands_jax", {"task": task}, device="cpu")
    jenv = _jax_env(task)
    keys = jax.random.split(jax.random.PRNGKey(4), 6)
    jreset, jstep = jax_fns(task)
    js, _ = jreset(keys)
    pos, t = np.array(js.obj_pos), np.array(js.t)
    succ = np.array(js.succeeded)
    pos[0, 0] = (0.5, 0.5, -0.5)                         # dropped, away from the hands
    pos[1] = np.asarray(js.goal_pos)[1]                  # at its goal: success
    t[2] = 74                                            # truncated
    t[3], pos[3, 0] = 74, (0.5, 0.5, -0.5)               # both: a drop, not a truncation
    succ[4] = True                                       # succeeded earlier: sticky
    js = js._replace(obj_pos=jnp.asarray(pos), t=jnp.asarray(t), succeeded=jnp.asarray(succ))
    a = np.zeros((6, 2, 20), np.float32)
    jnext, jfinal = jstep(js, jnp.asarray(a))
    k_env = jax.random.PRNGKey(9)
    state = tho.HandOverState(*(torch.from_numpy(np.array(x)) for x in js))
    ttr = auto_reset_step(tenv, state, torch.from_numpy(a),
                          _noise(tenv, _step_reset_keys(k_env, 6)))
    dones = ttr.final.dones[:, 0].numpy()
    np.testing.assert_array_equal(dones, np.asarray(jfinal.dones)[:, 0])
    np.testing.assert_array_equal(ttr.final.bad_transition.numpy(), jfinal.bad_transition)
    np.testing.assert_array_equal(ttr.final.metrics["won"].numpy(), jfinal.metrics["won"])
    assert dones.tolist() == [True, False, True, True, False, False]
    assert ttr.final.bad_transition.tolist() == [False, False, True, False, False, False]
    assert ttr.final.metrics["won"].tolist() == [0.0, 1.0, 0.0, 0.0, 1.0, 0.0]
    assert ttr.state.t.tolist() == [0, 1, 0, 0, 1, 1]
    _close(ttr.final.rewards, jfinal.rewards)
