"""The Bi-DexterousHands catch family for the port (counterpart of
``harl_tpu/envs/dexhands_jax/handover.py``), stepped as a batch of X
instances on one device.

Two simplified hands (5 fingers × abduction + 3 flexion joints, or the
4-finger Allegro layouts), servo-driven towards the actions' targets, catch,
toss and turn free sphere-inertia objects through penalty contacts (spring,
approach-only damping and regularised Coulomb friction) on every phalanx
pad and on the palms; 8 substeps of 1/480 s an env step. The 11 layouts,
the reward (proximity income, action penalty, optional arrival-speed
penalty), the sticky success flag that does not end an episode, drop
termination against truncation, the obs and share layouts and
``metrics["won"]`` are the JAX env's.

The JAX env takes the pads' velocities by ``jax.jvp`` through the finger
kinematics; the port writes the derivative of its cos/sin/cumsum chain out
(``HandKinematics.points``). The flexion angles pass through ``jnp.clip``, whose
tangent JAX takes as 1 inside the bounds, ½ at a bound and 0 outside: the
port uses the same rule (``clip_tangent``), since the substep clips a
servoed joint to exactly its limit.

Meta tasks draw a layout per episode; every layout-dependent quantity (hand
positions, directions) is gathered per env from the stacked tables.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from harl_tpu_torch.envs.core import TimeStep
from harl_tpu_torch.utils import spaces

# hand geometry -------------------------------------------------------------
N_FINGERS = 5
N_JOINTS = 4 * N_FINGERS                  # 20 per hand: abduction + 3 flexion
SEG_LEN = (0.045, 0.03, 0.025)            # finger segment lengths (m)
FINGER_BASE_X = np.array([-0.04, -0.02, 0.0, 0.02, 0.04])   # spread across palm
FINGER_BASE_Y = np.array([0.05, 0.055, 0.06, 0.055, 0.05])  # palm edge
ABDUCT_RANGE = 0.35                        # rad
FLEX_LO, FLEX_HI = -0.2, 1.7               # rad per flexion joint
SERVO_GAIN = 20.0                          # 1/s toward target
JOINT_VMAX = 18.0                          # rad/s
TIP_RADIUS = 0.016
PAD_RADII = (0.013, 0.014, TIP_RADIUS)     # proximal/middle/tip pads

# object / world ------------------------------------------------------------
OBJ_RADIUS = 0.035
OBJ_MASS = 0.08
OBJ_INERTIA = 0.4 * OBJ_MASS * OBJ_RADIUS ** 2   # solid sphere
GRAVITY = 9.81
PALM_HALF = 0.07                           # palm half-extent (square pad)
CONTACT_K = 1500.0
CONTACT_D = 16.0                           # approach-only contact damping
FRICTION_MU = 1.2
FRICTION_VREG = 0.05
DT = 1.0 / 480.0
SUBSTEPS = 8                               # control at 60 Hz


# task layouts: (hand_pos[2], fwd[2], up[2], obj_start_hand[n_obj],
# goal_hand[n_obj]); optional ``n_fingers`` (4 = Allegro), ``success``
# ("dist" | "rot" | "both"), ``layouts`` (meta tasks: base tasks drawn per
# episode), ``goal_noise`` (handover.py:196-269)
_TASKS = {
    "ShadowHandOver": dict(
        hand_pos=((0.0, 0.0, 0.0), (0.0, -0.30, 0.0)),
        fwd=(1.0, -1.0), up=(1.0, 1.0),
        obj_start_hand=(0,), goal_hand=(1,)),
    "ShadowHandCatchUnderarm": dict(
        hand_pos=((0.0, 0.0, 0.0), (0.0, -0.45, 0.0)),
        fwd=(1.0, -1.0), up=(1.0, 1.0),
        obj_start_hand=(0,), goal_hand=(1,)),
    "ShadowHandCatchOver2Underarm": dict(
        hand_pos=((0.0, 0.12, 0.30), (0.0, 0.0, 0.0)),
        fwd=(-1.0, 1.0), up=(-1.0, 1.0),
        obj_start_hand=(0,), goal_hand=(1,)),
    "ShadowHandCatchAbreast": dict(
        hand_pos=((-0.16, 0.0, 0.0), (0.16, 0.0, 0.0)),
        fwd=(1.0, 1.0), up=(1.0, 1.0),
        obj_start_hand=(0,), goal_hand=(1,)),
    "ShadowHandTwoCatchUnderarm": dict(
        hand_pos=((0.0, 0.0, 0.0), (0.0, -0.45, 0.0)),
        fwd=(1.0, -1.0), up=(1.0, 1.0),
        obj_start_hand=(0, 1), goal_hand=(1, 0)),
    "ShadowHandReOrientation": dict(
        hand_pos=((-0.16, 0.0, 0.0), (0.16, 0.0, 0.0)),
        fwd=(1.0, 1.0), up=(1.0, 1.0),
        obj_start_hand=(0, 1), goal_hand=(0, 1), success="rot"),
    "AllegroHandOver": dict(
        hand_pos=((0.0, 0.0, 0.0), (0.0, -0.30, 0.0)),
        fwd=(1.0, -1.0), up=(1.0, 1.0),
        obj_start_hand=(0,), goal_hand=(1,), n_fingers=4),
    "AllegroHandCatchUnderarm": dict(
        hand_pos=((0.0, 0.0, 0.0), (0.0, -0.45, 0.0)),
        fwd=(1.0, -1.0), up=(1.0, 1.0),
        obj_start_hand=(0,), goal_hand=(1,), n_fingers=4),
    "ShadowHandMetaMT1": dict(
        hand_pos=((0.0, 0.0, 0.0), (0.0, -0.45, 0.0)),
        fwd=(1.0, -1.0), up=(1.0, 1.0),
        obj_start_hand=(0,), goal_hand=(1,), goal_noise=0.03),
    "ShadowHandMetaML1": dict(
        hand_pos=((0.0, 0.0, 0.0), (0.0, -0.45, 0.0)),
        fwd=(1.0, -1.0), up=(1.0, 1.0),
        obj_start_hand=(0,), goal_hand=(1,), goal_noise=0.03),
    "ShadowHandMetaMT4": dict(
        layouts=("ShadowHandOver", "ShadowHandCatchUnderarm",
                 "ShadowHandCatchOver2Underarm", "ShadowHandCatchAbreast"),
        obj_start_hand=(0,), goal_hand=(1,), goal_noise=0.03),
}

DEXHANDS_TASKS = tuple(_TASKS)


def finger_base(n_fingers: int):
    """Per-finger base offsets across the palm edge (arch layout)."""
    if n_fingers == N_FINGERS:
        return FINGER_BASE_X, FINGER_BASE_Y
    x = np.linspace(-0.04, 0.04, n_fingers)
    y = 0.05 + 0.01 * np.sin(np.linspace(0.0, np.pi, n_fingers))
    return x, y


def clip_tangent(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """The tangent factor of ``jnp.clip(x, lo, hi)`` (max, then min): 1
    inside, ½ at a bound (a tie of max or min splits it), 0 outside."""
    inside = ((x > lo) & (x < hi)).to(x.dtype)
    return inside + 0.5 * ((x == lo) | (x == hi)).to(x.dtype)


class HandKinematics:
    """The finger chains of hands with ``n_fingers`` fingers, with their
    constants on ``device``."""

    def __init__(self, n_fingers: int, device: torch.device):
        f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
        bx, by = finger_base(n_fingers)
        self.n_fingers = n_fingers
        self.seg, self.bx, self.by = f(SEG_LEN), f(bx), f(by)

    def bases(self, hand_pos: torch.Tensor, fwd: torch.Tensor) -> torch.Tensor:
        """(..., F, 3) finger base points of hands at ``hand_pos`` (..., 3)
        extending along ``fwd`` (...,)."""
        by = fwd[..., None] * self.by
        return torch.stack([self.bx.expand(by.shape), by, torch.zeros_like(by)],
                           dim=-1) + hand_pos[..., None, :]

    def points(self, theta: torch.Tensor, base: torch.Tensor, fwd: torch.Tensor,
               up: torch.Tensor, theta_dot=None):
        """World positions of every phalanx endpoint, (..., F, 3, 3) ([..., -1,
        :] are the fingertips), and with ``theta_dot`` their velocities along it.

        ``theta`` (..., 4F) joint angles, ``base`` (..., F, 3) the fingers'
        base points, ``fwd`` and ``up`` (...,) the finger direction along y
        and the curl direction along z (handover.py:124-168)."""
        F, seg = self.n_fingers, self.seg
        th = theta.reshape(theta.shape[:-1] + (F, 4))
        abduct = th[..., 0] * ABDUCT_RANGE
        flex_raw = th[..., 1:]
        flex = torch.cumsum(torch.clamp(flex_raw, FLEX_LO, FLEX_HI), dim=-1)     # (..., F, 3)
        fwd, up = fwd[..., None], up[..., None]
        ca, sa = torch.cos(abduct), torch.sin(abduct)
        dir_xy = torch.stack([sa, fwd * ca], dim=-1)                              # (..., F, 2)
        cf, sf = torch.cos(flex), torch.sin(flex)
        cum_in = torch.cumsum(cf * seg, dim=-1)                                   # (..., F, 3)
        cum_up = up[..., None] * torch.cumsum(sf * seg, dim=-1)
        xy = base[..., None, :2] + dir_xy[..., None, :] * cum_in[..., None]
        z = base[..., None, 2] + cum_up
        pts = torch.cat([xy, z[..., None]], dim=-1)                               # (..., F, 3, 3)
        if theta_dot is None:
            return pts
        thd = theta_dot.reshape(th.shape)
        abduct_d = thd[..., 0] * ABDUCT_RANGE
        flex_d = torch.cumsum(clip_tangent(flex_raw, FLEX_LO, FLEX_HI) * thd[..., 1:], dim=-1)
        dir_d = torch.stack([ca * abduct_d, fwd * (-sa * abduct_d)], dim=-1)
        cum_in_d = torch.cumsum(-sf * flex_d * seg, dim=-1)
        cum_up_d = up[..., None] * torch.cumsum(cf * flex_d * seg, dim=-1)
        xy_d = (dir_d[..., None, :] * cum_in[..., None]
                + dir_xy[..., None, :] * cum_in_d[..., None])
        return pts, torch.cat([xy_d, cum_up_d[..., None]], dim=-1)


def servo(theta: torch.Tensor, tgt: torch.Tensor, n_fingers: int) -> torch.Tensor:
    """One substep of the joint servos: rate-limited towards the targets,
    abduction clipped to [−1, 1], flexion to its range."""
    theta_dot = torch.clamp(SERVO_GAIN * (tgt - theta), -JOINT_VMAX, JOINT_VMAX)
    new = (theta + DT * theta_dot).reshape(theta.shape[:-1] + (n_fingers, 4))
    new = torch.cat([torch.clamp(new[..., :1], -1.0, 1.0),
                     torch.clamp(new[..., 1:], FLEX_LO, FLEX_HI)], dim=-1)
    return new.reshape(theta.shape)


def servo_targets(actions: torch.Tensor, n_fingers: int) -> torch.Tensor:
    """Actions (X, 2, 4F) in [−1, 1] → joint targets: abduction as is,
    flexion mapped onto its range."""
    tgt = actions.reshape(actions.shape[:-1] + (n_fingers, 4))
    tgt = torch.cat([tgt[..., :1], FLEX_LO + (tgt[..., 1:] + 1.0) * 0.5 * (FLEX_HI - FLEX_LO)],
                    dim=-1)
    return tgt.reshape(actions.shape)


def servo_rates(theta_t: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    return torch.clamp(SERVO_GAIN * (theta_t - theta), -JOINT_VMAX, JOINT_VMAX)


def _quat_mul_omega(w: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(0, w) ⊗ q for w (..., 3), q (..., 4) wxyz."""
    x1, y1, z1 = w.unbind(-1)
    w2, x2, y2, z2 = q.unbind(-1)
    return torch.stack([-x1 * x2 - y1 * y2 - z1 * z2,
                        x1 * w2 + y1 * z2 - z1 * y2,
                        -x1 * z2 + y1 * w2 + z1 * x2,
                        x1 * y2 - y1 * x2 + z1 * w2], dim=-1)


def quat_angle(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rotation angle between unit quaternions, 2·arccos|⟨a, b⟩|."""
    d = torch.abs((a * b).sum(dim=-1))
    return 2.0 * torch.arccos(torch.clamp(d, -1.0, 1.0))


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1)


class HandOverState(NamedTuple):
    theta: torch.Tensor      # (X, 2, NJ) joint angles
    theta_t: torch.Tensor    # (X, 2, NJ) servo targets
    obj_pos: torch.Tensor    # (X, n_obj, 3)
    obj_quat: torch.Tensor   # (X, n_obj, 4) wxyz
    obj_vel: torch.Tensor    # (X, n_obj, 3)
    obj_omg: torch.Tensor    # (X, n_obj, 3)
    goal_pos: torch.Tensor   # (X, n_obj, 3)
    goal_quat: torch.Tensor  # (X, n_obj, 4)
    succeeded: torch.Tensor  # (X, n_obj) bool, sticky per object
    layout: torch.Tensor     # (X,) int32 layout index (meta tasks)
    t: torch.Tensor          # (X,) int32


class ShadowHandOver:
    """2-agent bimanual catch task over a batch of envs; agent h controls
    hand h's joints (20 Shadow, 16 Allegro)."""

    metric_keys = ("won",)

    def __init__(self, task: str = "ShadowHandOver", episode_length: int = 75,
                 vel_pen_coef: float = 0.0, vel_pen_width: float = 20.0,
                 device: torch.device = torch.device("cpu")):
        self.task = task
        self.episode_length = episode_length
        self.vel_pen_coef = vel_pen_coef
        self.vel_pen_width = vel_pen_width
        self.n_agents = 2
        self.device = torch.device(device)
        cfg = _TASKS[task]
        self._cfg = cfg
        names = cfg.get("layouts", (task,))
        rows = [_TASKS[n] if "layouts" in cfg else cfg for n in names]
        f = lambda key: torch.as_tensor(np.stack([np.asarray(r[key], np.float32) for r in rows]),
                                        device=self.device)
        self.n_layouts = len(names)
        self.hand_pos, self.fwd, self.up = f("hand_pos"), f("fwd"), f("up")   # (L, 2, 3), (L, 2)
        self.n_fingers = int(cfg.get("n_fingers", N_FINGERS))
        self.hands = HandKinematics(self.n_fingers, self.device)
        self.n_joints = 4 * self.n_fingers
        self.success_mode = cfg.get("success", "dist")
        self.n_objects = len(cfg["obj_start_hand"])
        self.start_hand = torch.as_tensor(cfg["obj_start_hand"], device=self.device)
        self.goal_hand = torch.as_tensor(cfg["goal_hand"], device=self.device)
        self.goal_noise = float(cfg.get("goal_noise", 0.01))
        self.drop_z = min(p[2] for r in rows for p in r["hand_pos"]) - 0.08
        self.pad_radii = torch.as_tensor(np.tile(np.asarray(PAD_RADII, np.float32),
                                                 self.n_fingers), device=self.device)
        self.eye_quat = torch.tensor([1.0, 0.0, 0.0, 0.0], device=self.device)

    @property
    def obs_dim(self) -> int:
        return 2 * self.n_joints + 3 * self.n_fingers + self.n_objects * (13 + 7 + 3)

    @property
    def state_dim(self) -> int:
        return 4 * self.n_joints + 6 * self.n_fingers + self.n_objects * (13 + 7 + 3)

    @property
    def reset_noise_spec(self):
        """The layout, the object start and goal position normals, the goal
        axis normals, then the goal angle uniforms (handover.py:375-410)."""
        n3 = 3 * self.n_objects
        return (("randint", 1, self.n_layouts), ("normal", n3), ("normal", n3),
                ("normal", n3), ("uniform", self.n_objects))

    @property
    def observation_space(self):
        return [spaces.Box.create(-np.inf, np.inf, self.obs_dim)] * 2

    @property
    def share_observation_space(self):
        return [spaces.Box.create(-np.inf, np.inf, self.state_dim)] * 2

    @property
    def action_space(self):
        return [spaces.Box.create(-1.0, 1.0, self.n_joints)] * 2

    def _hands(self, layout: torch.Tensor):
        """Per env: hand positions (X, 2, 3), fwd and up (X, 2)."""
        return self.hand_pos[layout], self.fwd[layout], self.up[layout]

    # ------------------------------------------------------------------ api
    def reset(self, noise) -> Tuple[HandOverState, TimeStep]:
        """``noise`` = (layout (X, 1) ints, three (X, 3·n_obj) normals, angle
        uniforms (X, n_obj)), as ``reset_noise_spec`` lists them."""
        layout_d, n1, n2, n3, u4 = noise
        X, n_obj = n1.shape[0], self.n_objects
        layout = layout_d[:, 0].to(device=self.device, dtype=torch.int32)
        hp, fw, up = self._hands(layout)
        rest = lambda hands: (hp[:, hands] + torch.stack(
            [torch.zeros_like(fw[:, hands]), fw[:, hands] * 0.045,
             up[:, hands] * (OBJ_RADIUS + 0.002)], dim=-1))
        obj_pos = rest(self.start_hand) + 0.01 * n1.reshape(X, n_obj, 3)
        goal_pos = rest(self.goal_hand) + self.goal_noise * n2.reshape(X, n_obj, 3)
        ax = n3.reshape(X, n_obj, 3)
        ax = ax / (_norm(ax)[..., None] + 1e-8)
        pi = float(np.float32(np.pi))
        ang = torch.clamp(u4 * (pi - (-pi)) + (-pi), min=-pi)
        goal_quat = torch.cat([torch.cos(ang / 2)[..., None], torch.sin(ang / 2)[..., None] * ax],
                              dim=-1)
        theta = torch.zeros(X, 2, self.n_joints, device=self.device)
        zeros3 = torch.zeros(X, n_obj, 3, device=self.device)
        state = HandOverState(
            theta=theta, theta_t=theta, obj_pos=obj_pos,
            obj_quat=self.eye_quat.expand(X, n_obj, 4).clone(), obj_vel=zeros3, obj_omg=zeros3,
            goal_pos=goal_pos, goal_quat=goal_quat,
            succeeded=torch.zeros(X, n_obj, dtype=torch.bool, device=self.device),
            layout=layout, t=torch.zeros(X, dtype=torch.int32, device=self.device))
        no = torch.zeros(X, dtype=torch.bool, device=self.device)
        return state, self._timestep(state, torch.zeros(X, device=self.device), no, no, no)

    def step(self, state: HandOverState, actions: torch.Tensor):
        """actions (X, 2, NJ) (handover.py:412-473)."""
        X = actions.shape[0]
        a = torch.clamp(actions.reshape(X, 2, self.n_joints), -1.0, 1.0)
        tgt = servo_targets(a, self.n_fingers)
        hp, fw, up = self._hands(state.layout)
        bases = self.hands.bases(hp, fw)                           # (X, 2, F, 3)
        theta, pos, quat, vel, omg = (state.theta, state.obj_pos, state.obj_quat,
                                      state.obj_vel, state.obj_omg)
        for _ in range(SUBSTEPS):
            theta, pos, quat, vel, omg = self._substep(theta, tgt, pos, quat, vel, omg,
                                                       bases, hp, fw, up)
        dist = _norm(pos - state.goal_pos)                         # (X, n_obj)
        rot = quat_angle(quat, state.goal_quat)
        reward = (torch.exp(-0.2 * (50.0 * dist + rot)).sum(dim=1)
                  - 0.0002 * (a ** 2).sum(dim=(1, 2)))
        if self.vel_pen_coef:
            speed = _norm(vel)
            reward = reward - self.vel_pen_coef * (
                speed * torch.exp(-self.vel_pen_width * dist)).sum(dim=1)
        ok_dist, ok_rot = dist < 0.03, rot < 0.1
        ok = {"rot": ok_rot, "both": ok_dist & ok_rot}.get(self.success_mode, ok_dist)
        succeeded = state.succeeded | ok
        success = succeeded.all(dim=1)
        dropped = (pos[..., 2] < self.drop_z).any(dim=1)
        new_t = state.t + 1
        trunc = new_t >= self.episode_length
        new_state = HandOverState(
            theta=theta, theta_t=tgt, obj_pos=pos, obj_quat=quat, obj_vel=vel, obj_omg=omg,
            goal_pos=state.goal_pos, goal_quat=state.goal_quat, succeeded=succeeded,
            layout=state.layout, t=new_t)
        return new_state, self._timestep(new_state, reward, dropped | trunc, trunc & ~dropped,
                                         success)

    # ------------------------------------------------------------- dynamics
    def _substep(self, theta, tgt, pos, quat, vel, omg, bases, hp, fw, up):
        new_theta = servo(theta, tgt, self.n_fingers)
        pads, pads_v = self.hands.points(new_theta, bases, fw, up, (new_theta - theta) / DT)
        X = pads.shape[0]
        pads = pads.reshape(X, 2, -1, 3)                           # (X, 2, 3F, 3)
        pads_v = pads_v.reshape(X, 2, -1, 3)
        force = torch.zeros_like(pos)
        force[..., 2] = -OBJ_MASS * GRAVITY
        f, tq = self._tip_contacts(pads, pads_v, pos, vel, omg)    # summed over hands
        pf, pt = self._palm_contact(pos, vel, omg, hp, up)
        force = force + f + pf
        torque = tq + pt
        if self.n_objects == 2:
            f01 = self._sphere_contact(pos[:, 0], vel[:, 0], pos[:, 1], vel[:, 1])
            force = force + torch.stack([f01, -f01], dim=1)
        new_vel = vel + DT * force / OBJ_MASS
        new_pos = pos + DT * new_vel
        new_omg = omg + DT * torque / OBJ_INERTIA
        new_quat = quat + DT * (0.5 * _quat_mul_omega(new_omg, quat))
        new_quat = new_quat / (_norm(new_quat)[..., None] + 1e-8)
        return new_theta, new_pos, new_quat, new_vel, new_omg

    def _tip_contacts(self, pads, pads_v, pos, vel, omg):
        """Forces and torques of both hands' pads on each object, (X, n_obj, 3)
        each; pads (X, 2, P, 3) (handover.py:526-548)."""
        d = pos[:, None, :, None] - pads[:, :, None]               # (X, 2, n_obj, P, 3)
        dist = _norm(d) + 1e-8
        n = d / dist[..., None]
        pen = torch.clamp(OBJ_RADIUS + self.pad_radii - dist, min=0.0)
        rc = -OBJ_RADIUS * n
        v_obj = vel[:, None, :, None] + torch.linalg.cross(omg[:, None, :, None], rc)
        v_rel = v_obj - pads_v[:, :, None]
        vn = (v_rel * n).sum(dim=-1)
        N = CONTACT_K * pen + CONTACT_D * torch.clamp(-vn, min=0.0) * (pen > 0)
        vt = v_rel - vn[..., None] * n
        vt_mag = _norm(vt) + FRICTION_VREG
        ft = -FRICTION_MU * N[..., None] * vt / vt_mag[..., None]
        f = N[..., None] * n + ft
        torque = torch.linalg.cross(rc, f).sum(dim=3)             # (X, 2, n_obj, 3)
        return f.sum(dim=3).sum(dim=1), torque.sum(dim=1)

    def _palm_contact(self, pos, vel, omg, hp, up):
        """Forces and torques of both palms on each object (handover.py:550-565)."""
        palm, up = hp[:, :, None], up[:, :, None]                  # (X, 2, 1, ·)
        p = pos[:, None]                                           # (X, 1, n_obj, 3)
        gap = up * (p[..., 2] - palm[..., 2]) - OBJ_RADIUS
        inside = ((torch.abs(p[..., 0] - palm[..., 0]) < PALM_HALF + OBJ_RADIUS)
                  & (torch.abs(p[..., 1] - palm[..., 1]) < PALM_HALF + OBJ_RADIUS))
        pen = torch.clamp(-gap, min=0.0) * inside
        zero = torch.zeros_like(up)
        n = torch.stack([zero, zero, up], dim=-1).expand(p.shape[:1] + (2,) + p.shape[2:])
        rc = -OBJ_RADIUS * n
        v_c = vel[:, None] + torch.linalg.cross(omg[:, None], rc)
        vn = (v_c * n).sum(dim=-1)
        N = CONTACT_K * pen + CONTACT_D * torch.clamp(-vn, min=0.0) * (pen > 0)
        vt = v_c - vn[..., None] * n
        ft = -FRICTION_MU * N[..., None] * vt / (_norm(vt) + FRICTION_VREG)[..., None]
        f = N[..., None] * n + ft
        return f.sum(dim=1), torch.linalg.cross(rc, f).sum(dim=1)

    @staticmethod
    def _sphere_contact(p0, v0, p1, v1):
        """Frictionless penalty force on object 0 from object 1 (TwoCatch)."""
        d = p0 - p1
        dist = _norm(d) + 1e-8
        n = d / dist[..., None]
        pen = torch.clamp(2 * OBJ_RADIUS - dist, min=0.0)
        vn = ((v0 - v1) * n).sum(dim=-1)
        N = CONTACT_K * pen + CONTACT_D * torch.clamp(-vn, min=0.0) * (pen > 0)
        return N[..., None] * n

    # ---------------------------------------------------------- observation
    def _timestep(self, state: HandOverState, reward, done, bad, success) -> TimeStep:
        X = state.theta.shape[0]
        theta_dot = servo_rates(state.theta_t, state.theta)
        hp, fw, up = self._hands(state.layout)
        tips = self.hands.points(state.theta, self.hands.bases(hp, fw), fw,
                                 up)[..., -1, :].reshape(X, 2, -1)    # (X, 2, 3F)
        obj = torch.cat([state.obj_pos, state.obj_quat, state.obj_vel, state.obj_omg],
                        dim=-1).reshape(X, -1)
        goal = torch.cat([state.goal_pos, state.goal_quat], dim=-1).reshape(X, -1)
        rel = (state.goal_pos - state.obj_pos).reshape(X, -1)
        task = torch.cat([obj, goal, rel], dim=-1)
        obs = torch.cat([state.theta, theta_dot, tips, task[:, None].expand(X, 2, -1)], dim=-1)
        share = torch.cat([state.theta.reshape(X, -1), theta_dot.reshape(X, -1),
                           tips.reshape(X, -1), task], dim=-1)
        return TimeStep(
            obs=obs,
            share_obs=share,
            rewards=reward[:, None, None].expand(X, 2, 1),
            dones=done[:, None].expand(X, 2),
            bad_transition=bad,
            metrics={"won": success.to(torch.float32)},
        )


def make_handover(env_args: dict, device: torch.device) -> ShadowHandOver:
    task = env_args.get("task", "ShadowHandOver")
    if task not in _TASKS:
        raise ValueError(f"dexhands_jax task {task!r}: available catch tasks are "
                         f"{DEXHANDS_TASKS}, manipulation tasks those of manip.py")
    return ShadowHandOver(
        task=task,
        episode_length=env_args.get("hands_episode_length", env_args.get("episode_limit", 75)),
        vel_pen_coef=float(env_args.get("vel_pen_coef", 0.0)),
        vel_pen_width=float(env_args.get("vel_pen_width", 20.0)),
        device=device)
