"""The Bi-DexterousHands manipulation family for the port (counterpart of
``harl_tpu/envs/dexhands_jax/manip.py``): doors, cup, scissors, switch and
bottle cap on one hinge; lift, push, stack, pen, grasp-and-place and kettle
on a table; stepped as a batch of X instances on one device.

The hands and their servos are the catch family's (``handover.py``), with
the fingertips alone as contacts and this family's own ``TIP_RADIUS`` and
``FRICTION_MU``; the table tasks mount the hands ``TABLE_HAND_DZ`` lower.
Hinge tasks integrate one revolute DOF (I θ̈ = τ − cθ̇ − spring − limits)
driven by the fingertips' forces on spherical handles; they carry one
dummy object row. Table tasks integrate free spheres on a support plane
with sphere-sphere friction. Success ends an episode here, unlike the
catch family: done = success | dropped | truncated. The fingertips'
velocities are the derivative of the finger chain written out, with the
clip's ½ tangent at the flexion limits (``handover.HandKinematics``).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from harl_tpu_torch.envs.core import TimeStep
from harl_tpu_torch.envs.dexhands_jax.handover import (
    CONTACT_D,
    CONTACT_K,
    DT,
    FRICTION_VREG,
    GRAVITY,
    N_FINGERS,
    N_JOINTS,
    SUBSTEPS,
    HandKinematics,
    servo,
    servo_rates,
    servo_targets,
)
from harl_tpu_torch.utils import spaces

# the contact constants this family was validated with (manip.py:56-62), not
# the catch family's
TIP_RADIUS = 0.012
FRICTION_MU = 1.0

HANDLE_R = 0.025
TABLE_Z = -0.05
TABLE_HAND_DZ = -0.025     # table tasks mount the hands lower

# hands: palm-up, facing each other across the workspace origin
_HANDS = dict(hand_pos=((0.0, -0.11, 0.0), (0.0, 0.11, 0.0)),
              fwd=(1.0, -1.0), up=(1.0, 1.0))

_DOOR = dict(
    kind="hinge", **_HANDS,
    hinge_pos=(-0.12, 0.0, 0.05),
    arms=((0.12, 0.0, 0.0),),          # one handle between the hands
    inertia=0.08, damping=2.0, spring=0.6, theta_limits=(-0.8, 0.8),
    success_tol=0.1,
)
_CUP = dict(
    kind="hinge", **_HANDS,
    hinge_pos=(0.0, 0.0, 0.04),
    arms=((0.08, 0.0, 0.0), (-0.08, 0.0, 0.0)),   # two opposed handles
    inertia=0.004, damping=0.05, spring=0.0, theta_limits=(-0.3, 3.6),
    success_tol=0.25,
)

MANIP_TASKS = {
    "ShadowHandDoorOpenOutward": {**_DOOR, "theta0": 0.0, "theta_goal": 0.5},
    "ShadowHandDoorOpenInward": {**_DOOR, "theta0": 0.0, "theta_goal": -0.5},
    "ShadowHandDoorCloseOutward": {**_DOOR, "theta0": 0.5, "theta_goal": 0.0},
    "ShadowHandDoorCloseInward": {**_DOOR, "theta0": -0.5, "theta_goal": 0.0},
    "ShadowHandSwingCup": {**_CUP, "theta0": 0.0, "theta_goal": float(np.pi)},
    "ShadowHandScissors": dict(
        kind="hinge", **_HANDS,
        hinge_pos=(0.0, 0.0, 0.04),
        arms=((0.07, 0.0, 0.0), (-0.07, 0.0, 0.0)),
        inertia=0.006, damping=0.2, spring=0.8, theta_limits=(-0.1, 1.0),
        success_tol=0.12, theta0=0.0, theta_goal=0.6,
    ),
    "ShadowHandSwitch": dict(
        kind="hinge", **_HANDS,
        hinge_pos=(-0.10, 0.0, 0.06),
        arms=((0.10, 0.0, 0.0),),
        inertia=0.02, damping=0.8, spring=1.2, theta_limits=(-0.8, 0.1),
        success_tol=0.1, theta0=0.0, theta_goal=-0.5,
    ),
    "ShadowHandBottleCap": dict(
        kind="hinge", **_HANDS,
        hinge_pos=(0.0, 0.0, 0.05),
        arms=((0.06, 0.0, 0.0),),
        inertia=0.002, damping=0.04, spring=0.0, theta_limits=(-0.2, 2.4),
        success_tol=0.25, theta0=0.0, theta_goal=1.8,
    ),
    # table tasks: (radius, mass, start xy, goal offset) per object
    "ShadowHandLiftUnderarm": dict(
        kind="table", **_HANDS,
        radii=(0.06,), masses=(1.0,),
        starts=((0.0, 0.0),), goals=((0.0, 0.0, 0.22),),
        success_tol=0.06,
    ),
    "ShadowHandPushBlock": dict(
        kind="table", **_HANDS,
        radii=(0.03, 0.03), masses=(0.10, 0.10),
        starts=((-0.03, -0.03), (0.03, 0.03)),
        goals=((-0.09, 0.0, 0.0), (0.09, 0.0, 0.0)),
        success_tol=0.05,
    ),
    "ShadowHandBlockStack": dict(
        kind="table", **_HANDS,
        radii=(0.035, 0.035), masses=(0.10, 0.10),
        starts=((-0.04, 0.0), (0.05, 0.0)),
        goals=((0.0, 0.0, 0.0), (0.0, 0.0, 0.07)),
        success_tol=0.045,
    ),
    "ShadowHandPen": dict(
        kind="table", **_HANDS,
        radii=(0.02,), masses=(0.05,),
        starts=((0.0, 0.0),), goals=((0.06, 0.0, 0.12),),
        success_tol=0.05,
    ),
    "ShadowHandGraspAndPlace": dict(
        kind="table", **_HANDS,
        radii=(0.03,), masses=(0.15,),
        starts=((0.0, -0.02),), goals=((0.12, 0.0, 0.0),),
        success_tol=0.04,
    ),
    "ShadowHandKettle": dict(
        kind="table", **_HANDS,
        radii=(0.05,), masses=(0.8,),
        starts=((0.0, 0.0),), goals=((0.06, 0.0, 0.18),),
        success_tol=0.06,
    ),
}

DEXHANDS_MANIP_TASKS = tuple(MANIP_TASKS)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1)


def tip_sphere_contact(tips, tips_v, pos, vel, radius) -> torch.Tensor:
    """Penalty forces of fingertips (..., T, 3) on a sphere at ``pos`` (..., 3)
    moving at ``vel``, summed over the tips (manip.py:189-202)."""
    d = pos[..., None, :] - tips
    dist = _norm(d) + 1e-8
    n = d / dist[..., None]
    pen = torch.clamp(radius + TIP_RADIUS - dist, min=0.0)
    v_rel = vel[..., None, :] - tips_v
    vn = (v_rel * n).sum(dim=-1)
    N = torch.clamp(CONTACT_K * pen - CONTACT_D * vn * (pen > 0), min=0.0)
    vt = v_rel - vn[..., None] * n
    ft = -FRICTION_MU * N[..., None] * vt / (_norm(vt) + FRICTION_VREG)[..., None]
    return (N[..., None] * n + ft).sum(dim=-2)


class ManipState(NamedTuple):
    theta: torch.Tensor       # (X, 2, 20)
    theta_t: torch.Tensor     # (X, 2, 20)
    hinge: torch.Tensor       # (X,) hinge angle (hinge tasks; 0 otherwise)
    hinge_vel: torch.Tensor   # (X,)
    obj_pos: torch.Tensor     # (X, n_obj, 3) table tasks; (X, 1, 3) zeros for hinge
    obj_vel: torch.Tensor     # (X, n_obj, 3)
    t: torch.Tensor           # (X,) int32


class ShadowHandManip:
    """2-agent manipulation task over a batch of envs; agent h controls hand
    h's 20 joints."""

    metric_keys = ("won",)

    def __init__(self, task: str = "ShadowHandDoorOpenOutward", episode_length: int = 125,
                 device: torch.device = torch.device("cpu")):
        self.task = task
        self.episode_length = episode_length
        self.n_agents = 2
        self.device = torch.device(device)
        c = self._cfg = MANIP_TASKS[task]
        self.is_hinge = c["kind"] == "hinge"
        f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        dz = 0.0 if self.is_hinge else TABLE_HAND_DZ
        hand_pos = f([np.asarray(p) + np.array([0.0, 0.0, dz]) for p in c["hand_pos"]])
        self.fwd, self.up = f(c["fwd"]), f(c["up"])
        self.hands = HandKinematics(N_FINGERS, self.device)
        self.bases = self.hands.bases(hand_pos, self.fwd)          # (2, F, 3)
        if self.is_hinge:
            self.n_obj, self.n_handles = 0, len(c["arms"])
            self.hinge_pos, self.arms = f(c["hinge_pos"]), f(c["arms"])
            goal = torch.tensor(c["theta_goal"], dtype=torch.float32, device=self.device)
            self.goal_obs = torch.stack([torch.sin(goal), torch.cos(goal)])
        else:
            self.n_obj, self.n_handles = len(c["radii"]), 0
            self.radii, self.masses = f(c["radii"]), f(c["masses"])
            rest = f([[0.0, 0.0, TABLE_Z + r] for r in c["radii"]])
            self.goals = f(c["goals"]) + rest                      # table-level goals at rest
            self.starts = f([(s[0], s[1], TABLE_Z + c["radii"][o])
                             for o, s in enumerate(c["starts"])])

    @property
    def _task_obs_dim(self) -> int:
        if self.is_hinge:
            return 3 + 3 * self.n_handles + 3
        return self.n_obj * 12

    @property
    def obs_dim(self) -> int:
        return 20 + 20 + 15 + self._task_obs_dim

    @property
    def state_dim(self) -> int:
        return 40 + 40 + 30 + self._task_obs_dim

    @property
    def reset_noise_spec(self):
        """The hinge angle's normal, or the objects' start normals
        (manip.py:296-315)."""
        return (("normal", 1 if self.is_hinge else 3 * self.n_obj),)

    @property
    def observation_space(self):
        return [spaces.Box.create(-np.inf, np.inf, self.obs_dim)] * 2

    @property
    def share_observation_space(self):
        return [spaces.Box.create(-np.inf, np.inf, self.state_dim)] * 2

    @property
    def action_space(self):
        return [spaces.Box.create(-1.0, 1.0, N_JOINTS)] * 2

    def _handles(self, theta: torch.Tensor) -> torch.Tensor:
        """World handle centres (X, H, 3) at hinge angles (X,)."""
        ct, st = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
        a = self.arms
        return self.hinge_pos + torch.stack(
            [ct * a[:, 0] - st * a[:, 1], st * a[:, 0] + ct * a[:, 1],
             a[:, 2].expand(ct.shape[0], -1)], dim=-1)

    def _tips(self, theta: torch.Tensor, theta_dot=None):
        """Fingertips (X, 2, F, 3) of both hands, and their velocities."""
        out = self.hands.points(theta, self.bases, self.fwd, self.up, theta_dot)
        if theta_dot is None:
            return out[..., -1, :]
        return out[0][..., -1, :], out[1][..., -1, :]

    # ------------------------------------------------------------------ api
    def reset(self, noise) -> Tuple[ManipState, TimeStep]:
        (n,) = noise
        c, X = self._cfg, n.shape[0]
        theta = torch.zeros(X, 2, N_JOINTS, device=self.device)
        zero = torch.zeros(X, device=self.device)
        if self.is_hinge:
            obj_pos = torch.zeros(X, 1, 3, device=self.device)      # one dummy row
            obj_vel = obj_pos
            hinge = c["theta0"] + 0.02 * n[:, 0]
        else:
            obj_pos = self.starts + 0.005 * n.reshape(X, self.n_obj, 3)
            obj_vel = torch.zeros_like(obj_pos)
            hinge = zero
        state = ManipState(theta=theta, theta_t=theta, hinge=hinge, hinge_vel=zero,
                           obj_pos=obj_pos, obj_vel=obj_vel,
                           t=torch.zeros(X, dtype=torch.int32, device=self.device))
        no = torch.zeros(X, dtype=torch.bool, device=self.device)
        return state, self._timestep(state, zero, no, no, no)

    def step(self, state: ManipState, actions: torch.Tensor):
        """actions (X, 2, 20) (manip.py:323-380)."""
        c, X = self._cfg, actions.shape[0]
        a = torch.clamp(actions.reshape(X, 2, N_JOINTS), -1.0, 1.0)
        tgt = servo_targets(a, N_FINGERS)
        theta, hinge, hinge_vel = state.theta, state.hinge, state.hinge_vel
        pos, vel = state.obj_pos, state.obj_vel
        for _ in range(SUBSTEPS):
            theta, hinge, hinge_vel, pos, vel = self._substep(theta, tgt, hinge, hinge_vel,
                                                              pos, vel)
        tips = self._tips(theta).reshape(X, 2, N_FINGERS, 1, 3)
        if self.is_hinge:
            err = torch.abs(hinge - c["theta_goal"])
            success = err < c["success_tol"]
            targets = self._handles(hinge)
            dropped = torch.zeros_like(success)
        else:
            dist = _norm(pos - self.goals)
            slow = (_norm(vel) < 0.5).all(dim=1)
            success = (dist < c["success_tol"]).all(dim=1) & slow
            targets = pos
            dropped = ((pos[..., 2] < TABLE_Z - 0.05) | (_norm(pos[..., :2]) > 0.3)).any(dim=1)
        # each hand approaches its nearest handle or object
        app = _norm(tips - targets[:, None, None]).amin(dim=(2, 3))   # (X, 2)
        app = app[:, 0] + app[:, 1]
        if self.is_hinge:
            reward = -2.0 * err - 0.5 * app + 5.0 * success.to(torch.float32)
        else:
            reward = ((-2.0 * dist).sum(dim=1) - 0.5 * app + 5.0 * success.to(torch.float32)
                      - 2.0 * dropped.to(torch.float32))
        new_t = state.t + 1
        trunc = new_t >= self.episode_length
        ended = success | dropped
        new_state = ManipState(theta=theta, theta_t=tgt, hinge=hinge, hinge_vel=hinge_vel,
                               obj_pos=pos, obj_vel=vel, t=new_t)
        return new_state, self._timestep(new_state, reward, ended | trunc, trunc & ~ended,
                                         success)

    # ------------------------------------------------------------- dynamics
    def _substep(self, theta, tgt, hinge, hinge_vel, pos, vel):
        c = self._cfg
        new_theta = servo(theta, tgt, N_FINGERS)
        tips, tips_v = self._tips(new_theta, (new_theta - theta) / DT)    # (X, 2, F, 3)
        X = tips.shape[0]
        if self.is_hinge:
            handles = self._handles(hinge)                                 # (X, H, 3)
            arm = handles - self.hinge_pos
            zero = torch.zeros_like(arm[..., 0])
            hv = torch.stack([-hinge_vel[:, None] * arm[..., 1], hinge_vel[:, None] * arm[..., 0],
                              zero], dim=-1)                               # [0, 0, ω] × arm
            # each hand's five tips on each handle, the hands summed
            f = tip_sphere_contact(tips[:, :, None], tips_v[:, :, None], handles[:, None],
                                   hv[:, None], HANDLE_R).sum(dim=1)       # (X, H, 3)
            torque = (arm[..., 0] * f[..., 1] - arm[..., 1] * f[..., 0]).sum(dim=1)
            lo, hi = c["theta_limits"]
            over = torch.clamp(hinge - hi, min=0.0) - torch.clamp(lo - hinge, min=0.0)
            acc = (torque - c["damping"] * hinge_vel - c.get("spring", 0.0) * (hinge - c["theta0"])
                   - 50.0 * over) / c["inertia"]
            new_vel = torch.clamp(hinge_vel + DT * acc, -20.0, 20.0)
            return new_theta, hinge + DT * new_vel, new_vel, pos, vel
        tips, tips_v = tips.reshape(X, 1, -1, 3), tips_v.reshape(X, 1, -1, 3)
        f = tip_sphere_contact(tips, tips_v, pos, vel, self.radii[:, None])  # (X, n_obj, 3)
        # table support: normal spring + friction against the plane
        pen = torch.clamp(TABLE_Z + self.radii - pos[..., 2], min=0.0)
        N = torch.clamp(CONTACT_K * pen - CONTACT_D * vel[..., 2] * (pen > 0), min=0.0)
        vt = torch.cat([vel[..., :2], torch.zeros_like(vel[..., 2:])], dim=-1)
        ft = -FRICTION_MU * N[..., None] * vt / (_norm(vt) + FRICTION_VREG)[..., None]
        support = torch.cat([ft[..., :2], (N + ft[..., 2])[..., None]], dim=-1)
        f = f + support
        if self.n_obj == 2:   # sphere-sphere contacts with friction (stacking)
            d = pos - pos.flip(1)
            dist = _norm(d) + 1e-8
            n = d / dist[..., None]
            pen2 = torch.clamp(self.radii + self.radii.flip(0) - dist, min=0.0)
            v_rel = vel - vel.flip(1)
            vn = (v_rel * n).sum(dim=-1)
            N2 = torch.clamp(CONTACT_K * pen2 - CONTACT_D * vn * (pen2 > 0), min=0.0)
            vt2 = v_rel - vn[..., None] * n
            ft2 = -FRICTION_MU * N2[..., None] * vt2 / (_norm(vt2) + FRICTION_VREG)[..., None]
            f = f + (N2[..., None] * n + ft2)
        gravity = torch.zeros_like(pos)
        gravity[..., 2] = -GRAVITY
        force = gravity * self.masses[:, None] + f
        new_vel = vel + DT * force / self.masses[:, None]
        return new_theta, hinge, hinge_vel, pos + DT * new_vel, new_vel

    # ---------------------------------------------------------- observation
    def _task_obs(self, state: ManipState) -> torch.Tensor:
        X = state.theta.shape[0]
        if self.is_hinge:
            goal = self._cfg["theta_goal"]
            return torch.cat([
                torch.stack([torch.sin(state.hinge), torch.cos(state.hinge), state.hinge_vel],
                            dim=1),
                self._handles(state.hinge).reshape(X, -1),
                self.goal_obs.expand(X, 2), (goal - state.hinge)[:, None]], dim=1)
        goals = self.goals.expand(X, -1, -1)
        return torch.cat([state.obj_pos.reshape(X, -1), state.obj_vel.reshape(X, -1),
                          goals.reshape(X, -1), (goals - state.obj_pos).reshape(X, -1)], dim=1)

    def _timestep(self, state: ManipState, reward, done, bad, success) -> TimeStep:
        X = state.theta.shape[0]
        theta_dot = servo_rates(state.theta_t, state.theta)
        tips = self._tips(state.theta).reshape(X, 2, -1)
        tobs = self._task_obs(state)
        obs = torch.cat([state.theta, theta_dot, tips, tobs[:, None].expand(X, 2, -1)], dim=-1)
        share = torch.cat([state.theta.reshape(X, -1), theta_dot.reshape(X, -1),
                           tips.reshape(X, -1), tobs], dim=-1)
        return TimeStep(
            obs=obs,
            share_obs=share,
            rewards=reward[:, None, None].expand(X, 2, 1),
            dones=done[:, None].expand(X, 2),
            bad_transition=bad,
            metrics={"won": success.to(torch.float32)},
        )


def make_manip(env_args: dict, device: torch.device) -> ShadowHandManip:
    task = env_args.get("task", "ShadowHandDoorOpenOutward")
    if task not in MANIP_TASKS:
        raise ValueError(f"dexhands_jax manip task {task!r}: available {DEXHANDS_MANIP_TASKS}")
    return ShadowHandManip(
        task=task,
        episode_length=env_args.get("hands_episode_length", env_args.get("episode_limit", 125)),
        device=device)
