"""Planar HalfCheetah, Walker2d and Hopper for the port (counterpart of
``harl_tpu/envs/mamujoco_jax/planar.py``).

Each robot is an articulated planar rigid-body tree in generalized
coordinates q = (x, z, pitch, θ₁…θₙ), stepped as a batch of X instances on
one device:

    M(q) = Σ mᵢ JᵢᵀJᵢ + Σ Iᵢ gᵢgᵢᵀ + diag(armature)
    Q    = Bτ + spring/limit + gravity + contact − coriolis
    (M + dt·D) q̇′ = M q̇ + dt·Q     — semi-implicit Euler, implicit damping
    q′ = q + dt·q̇′

with the closed-form kinematics of the JAX package's batch form
(``_kin_analytic_b``, ``_substep_b``), the batch as the leading dimension,
and the same unrolled Gauss–Jordan solve (no pivoting: M + dt·D is SPD).
Ground contact is the same soft-penalty model on capsule spheres. The sums
over the term table, the bodies and the contacts that a batched matmul
would round by the batch's width on the card are ``fixed_sum``'s, so an
env's step does not depend on how many envs share its batch.

The cheetah never terminates: its episodes end by truncation at
``episode_limit``. Walker2d and Hopper earn a healthy reward and terminate
when unhealthy (torso height, pitch, and for the hopper every joint angle and
velocity in range): a termination clears ``masks``, and ``bad_transition``
marks truncations only. Their state vectors clip qvel to ±10. Constants are
computed in float64 with numpy and stored in float32, as the JAX package
stores them; the arithmetic is float32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from harl_tpu_torch.envs.core import TimeStep
from harl_tpu_torch.envs.mamujoco_jax.fixed_sum import fixed_sum
from harl_tpu_torch.utils import spaces

GRAVITY = 9.81


# =============================================================== robot spec
@dataclasses.dataclass(frozen=True)
class Geom:
    body: int
    pos: Tuple[float, float]      # capsule center in body frame (x, z)
    axis: Tuple[float, float]     # unit direction of the capsule axis (x, z)
    half_len: float
    radius: float
    friction: float = 0.9


@dataclasses.dataclass(frozen=True)
class RobotSpec:
    name: str
    parents: Tuple[int, ...]                    # per body; -1 = root (body 0)
    body_pos: Tuple[Tuple[float, float], ...]   # body origin in parent frame
    joint_pos: Tuple[Tuple[float, float], ...]  # hinge anchor in body frame
    joint_sign: Tuple[float, ...]
    geoms: Tuple[Geom, ...]
    joint_range: Tuple[Tuple[float, float], ...]  # radians
    joint_damping: Tuple[float, ...]
    joint_stiffness: Tuple[float, ...]
    joint_armature: Tuple[float, ...]
    gears: Tuple[float, ...]
    total_mass: Optional[float]
    z_off: float
    qpos0_z: float
    dt: float
    frame_skip: int
    contact_stiffness: float
    contact_damping: float
    friction_vreg: float = 0.1
    limit_stiffness: float = 4000.0
    limit_damping: float = 40.0
    reset_qpos_noise: float = 5e-3     # uniform half-width
    reset_qvel_noise: float = 5e-3
    reset_qvel_normal: bool = False    # cheetah: qvel = scale · N(0, 1)
    forward_reward_weight: float = 1.0
    ctrl_cost_weight: float = 1e-3
    healthy_reward: float = 0.0
    terminate_when_unhealthy: bool = False
    healthy_z_range: Tuple[float, float] = (-np.inf, np.inf)
    healthy_angle_range: Tuple[float, float] = (-np.inf, np.inf)
    healthy_state_range: Tuple[float, float] = (-np.inf, np.inf)
    clip_qvel_obs: float = 0.0         # 0: no clipping (cheetah)

    @property
    def n_bodies(self) -> int:
        return len(self.parents)

    @property
    def n_joints(self) -> int:
        return self.n_bodies - 1

    @property
    def dof(self) -> int:
        return self.n_joints + 3

    @property
    def obs_dim(self) -> int:
        return (self.dof - 1) + self.dof  # qpos[1:] + qvel


def _capsule_mass_inertia(half_len: float, radius: float, density: float = 1000.0):
    """Mass and perpendicular-axis moment of inertia (about COM) of a capsule."""
    r, h = radius, half_len
    m_cyl = density * math.pi * r * r * (2 * h)
    m_cap = density * (4.0 / 3.0) * math.pi * r ** 3
    i_cyl = m_cyl * ((2 * h) ** 2 / 12.0 + r * r / 4.0)
    d = h + 3.0 * r / 8.0
    i_cap = 2 * ((83.0 / 320.0) * (m_cap / 2) * r * r + (m_cap / 2) * d * d)
    return m_cyl + m_cap, i_cyl + i_cap


def _ax(a: float) -> Tuple[float, float]:
    """Capsule axis from MuJoCo ``axisangle="0 1 0 a"``: (sin a, cos a)."""
    return (math.sin(a), math.cos(a))


HALF_CHEETAH = RobotSpec(
    name="HalfCheetah",
    parents=(-1, 0, 1, 2, 0, 4, 5),
    body_pos=((0, 0), (-0.5, 0), (0.16, -0.25), (-0.28, -0.14),
              (0.5, 0), (-0.14, -0.24), (0.13, -0.18)),
    joint_pos=((0, 0),) * 7,
    joint_sign=(1.0,) * 6,
    geoms=(
        Geom(0, (0.0, 0.0), (1.0, 0.0), 0.5, 0.046, 0.4),          # torso
        Geom(0, (0.6, 0.1), _ax(0.87), 0.15, 0.046, 0.4),          # head
        Geom(1, (0.1, -0.13), _ax(-3.8), 0.145, 0.046, 0.4),       # bthigh
        Geom(2, (-0.14, -0.07), _ax(-2.03), 0.15, 0.046, 0.4),     # bshin
        Geom(3, (0.03, -0.097), _ax(-0.27), 0.094, 0.046, 0.4),    # bfoot
        Geom(4, (-0.07, -0.12), _ax(0.52), 0.133, 0.046, 0.4),     # fthigh
        Geom(5, (0.065, -0.09), _ax(-0.6), 0.106, 0.046, 0.4),     # fshin
        Geom(6, (0.045, -0.07), _ax(-0.6), 0.07, 0.046, 0.4),      # ffoot
    ),
    joint_range=((-0.52, 1.05), (-0.785, 0.785), (-0.4, 0.785),
                 (-1.0, 0.7), (-1.2, 0.87), (-0.5, 0.5)),
    joint_damping=(6.0, 4.5, 3.0, 4.5, 3.0, 1.5),
    joint_stiffness=(240.0, 180.0, 120.0, 180.0, 120.0, 60.0),
    joint_armature=(0.1,) * 6,
    gears=(120.0, 90.0, 60.0, 120.0, 60.0, 30.0),
    total_mass=14.0,
    z_off=0.7,
    qpos0_z=0.0,
    dt=0.01,
    frame_skip=5,
    contact_stiffness=8000.0,
    contact_damping=250.0,
    reset_qpos_noise=0.1,
    reset_qvel_noise=0.1,
    reset_qvel_normal=True,
    forward_reward_weight=1.0,
    ctrl_cost_weight=0.1,
)

_W_RANGE = ((-150 * math.pi / 180, 0.0), (-150 * math.pi / 180, 0.0),
            (-45 * math.pi / 180, 45 * math.pi / 180))

WALKER2D = RobotSpec(
    name="Walker2d",
    parents=(-1, 0, 1, 2, 0, 4, 5),
    body_pos=((0, 0), (0, -0.2), (0, -0.7), (0.2, -0.35),
              (0, -0.2), (0, -0.7), (0.2, -0.35)),
    joint_pos=((0, 0), (0, 0), (0, 0.25), (-0.2, 0.1),
               (0, 0), (0, 0.25), (-0.2, 0.1)),
    joint_sign=(-1.0,) * 6,
    geoms=(
        Geom(0, (0.0, 0.0), (0.0, 1.0), 0.2, 0.05, 0.9),           # torso
        Geom(1, (0.0, -0.225), (0.0, 1.0), 0.225, 0.05, 0.9),      # thigh
        Geom(2, (0.0, 0.0), (0.0, 1.0), 0.25, 0.04, 0.9),          # leg
        Geom(3, (-0.1, 0.1), (-1.0, 0.0), 0.1, 0.06, 0.9),         # foot
        Geom(4, (0.0, -0.225), (0.0, 1.0), 0.225, 0.05, 0.9),      # thigh_left
        Geom(5, (0.0, 0.0), (0.0, 1.0), 0.25, 0.04, 0.9),          # leg_left
        Geom(6, (-0.1, 0.1), (-1.0, 0.0), 0.1, 0.06, 1.9),         # foot_left
    ),
    joint_range=_W_RANGE + _W_RANGE,
    joint_damping=(0.1,) * 6,
    joint_stiffness=(0.0,) * 6,
    joint_armature=(0.01,) * 6,
    gears=(100.0,) * 6,
    total_mass=None,
    z_off=0.0,
    qpos0_z=1.25,
    dt=0.002,
    frame_skip=4,
    contact_stiffness=20000.0,
    contact_damping=500.0,
    forward_reward_weight=1.0,
    ctrl_cost_weight=1e-3,
    healthy_reward=1.0,
    terminate_when_unhealthy=True,
    healthy_z_range=(0.8, 2.0),
    healthy_angle_range=(-1.0, 1.0),
    clip_qvel_obs=10.0,
)

HOPPER = RobotSpec(
    name="Hopper",
    parents=(-1, 0, 1, 2),
    body_pos=((0, 0), (0, -0.2), (0, -0.7), (0.13, -0.35)),
    joint_pos=((0, 0), (0, 0), (0, 0.25), (-0.13, 0.1)),
    joint_sign=(-1.0,) * 3,
    geoms=(
        Geom(0, (0.0, 0.0), (0.0, 1.0), 0.2, 0.05, 0.9),           # torso
        Geom(1, (0.0, -0.225), (0.0, 1.0), 0.225, 0.05, 0.9),      # thigh
        Geom(2, (0.0, 0.0), (0.0, 1.0), 0.25, 0.04, 0.9),          # leg
        Geom(3, (-0.065, 0.1), (-1.0, 0.0), 0.195, 0.06, 2.0),     # foot
    ),
    joint_range=_W_RANGE,
    joint_damping=(1.0,) * 3,
    joint_stiffness=(0.0,) * 3,
    joint_armature=(1.0,) * 3,
    gears=(200.0,) * 3,
    total_mass=None,
    z_off=0.0,
    qpos0_z=1.25,
    dt=0.002,
    frame_skip=4,
    contact_stiffness=20000.0,
    contact_damping=500.0,
    forward_reward_weight=1.0,
    ctrl_cost_weight=1e-3,
    healthy_reward=1.0,
    terminate_when_unhealthy=True,
    healthy_z_range=(0.7, np.inf),
    healthy_angle_range=(-0.2, 0.2),
    healthy_state_range=(-100.0, 100.0),
    clip_qvel_obs=10.0,
)

SPECS = {"HalfCheetah": HALF_CHEETAH, "Walker2d": WALKER2D, "Hopper": HOPPER}


def gauss_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for a batch of small SPD systems, A (X, n, n), b (X, n),
    by unrolled Gauss–Jordan elimination without pivoting — the elimination
    of the JAX package's ``_gauss_solve`` (division by the pivot), as n
    rank-1 updates over the whole batch."""
    n = A.shape[-1]
    A = A.clone()
    b = b.clone()
    for j in range(n):
        piv = A[:, j, j]
        pivot_row = A[:, j] / piv[:, None]           # (X, n)
        pivot_b = b[:, j] / piv                      # (X,)
        factor = A[:, :, j].clone()                  # (X, n)
        factor[:, j] = 0.0
        A = A - factor[:, :, None] * pivot_row[:, None, :]
        A[:, j] = pivot_row
        b = b - factor * pivot_b[:, None]
        b[:, j] = pivot_b
    return b


# ============================================================== the dynamics
class PlanarState(NamedTuple):
    q: torch.Tensor   # (X, dof)
    qd: torch.Tensor  # (X, dof)
    t: torch.Tensor   # (X,) int32


class PlanarDynamics:
    """Constant tensors from a RobotSpec and the batched physics step."""

    def __init__(self, spec: RobotSpec, device: torch.device):
        self.spec = spec
        self.device = device
        B = spec.n_bodies
        masses = np.zeros(B)
        coms = np.zeros((B, 2))
        inertias = np.zeros(B)
        per_geom = [np.array(_capsule_mass_inertia(g.half_len, g.radius))
                    for g in spec.geoms]
        for g, (m, _) in zip(spec.geoms, per_geom):
            masses[g.body] += m
            coms[g.body] += m * np.asarray(g.pos)
        coms /= masses[:, None]
        for g, (m, i) in zip(spec.geoms, per_geom):
            d2 = np.sum((np.asarray(g.pos) - coms[g.body]) ** 2)
            inertias[g.body] += i + m * d2
        if spec.total_mass is not None:
            scale = spec.total_mass / masses.sum()
            masses *= scale
            inertias *= scale
        G = np.zeros((B, spec.dof))
        G[:, 2] = 1.0
        for b in range(1, B):
            G[b] = G[spec.parents[b]].copy()
            G[b, 3 + b - 1] = spec.joint_sign[b - 1]
        pts, rads, mus, bodies = [], [], [], []
        for g in spec.geoms:
            c, d = np.asarray(g.pos), np.asarray(g.axis)
            for s in (-g.half_len, 0.0, g.half_len):
                pts.append(c + s * d)
                rads.append(g.radius)
                mus.append(g.friction)
                bodies.append(g.body)
        jr = np.asarray(spec.joint_range)
        # analytic-kinematics term table: every body origin is
        # root + Σ_t A[b,t]·R(ang_{tb_t})·V_t
        nT = max(2 * (B - 1), 1)
        A = np.zeros((B, nT))
        tb = np.zeros(nT, np.int64)
        V = np.zeros((nT, 2))
        for b in range(1, B):
            p = spec.parents[b]
            t1, t2 = 2 * (b - 1), 2 * (b - 1) + 1
            tb[t1] = p
            V[t1] = np.asarray(spec.body_pos[b]) + np.asarray(spec.joint_pos[b])
            tb[t2] = b
            V[t2] = -np.asarray(spec.joint_pos[b])
            A[b] = A[p]
            A[b, t1] = 1.0
            A[b, t2] = 1.0
        cb = np.asarray(bodies)

        f = self._const
        self.masses = f(masses)
        self.coms = f(coms)
        self.inertias = f(inertias)
        self.G_ang = f(G)
        self.cpts = f(np.stack(pts))
        self.crad = f(rads)
        self.cmu = f(mus)
        self.armature = f(np.concatenate([np.zeros(3), spec.joint_armature]))
        self.joint_damp = f(np.concatenate([np.zeros(3), spec.joint_damping]))
        self.joint_stiff = f(np.concatenate([np.zeros(3), spec.joint_stiffness]))
        self.q_lo = f(np.concatenate([np.full(3, -np.inf), jr[:, 0]]))
        self.q_hi = f(np.concatenate([np.full(3, np.inf), jr[:, 1]]))
        self.gears = f(spec.gears)
        self.kin_A = f(A)
        self.kin_tb = torch.as_tensor(tb, device=device)
        self.kin_V = f(V)
        self.kin_Gt = f(G[tb])
        self.kin_cb = torch.as_tensor(cb, device=device)
        self.kin_Gc = f(G[cb])
        # the kinematics' contractions over the term table as elementwise
        # products with constants (A and G are 0 or ±1, so these are exact)
        self.kin_AG = self.kin_A[:, :, None, None] * self.kin_Gt[None, :, None, :]  # (B,T,1,dof)
        self.kin_A3 = self.kin_A[:, :, None]                                        # (B, T, 1)
        # the state-independent part of the mass matrix, armature and 1e-9·I
        M_inertia = torch.einsum("b,bi,bj->ij", self.inertias, self.G_ang, self.G_ang)
        self.M_const = (M_inertia + torch.diag(self.armature)
                        + 1e-9 * torch.eye(spec.dof, device=device))

    def _const(self, x) -> torch.Tensor:
        """float64 numpy → float32, as the JAX package stores it."""
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    # ------------------------------------------------- analytic kinematics
    def kin_analytic(self, q: torch.Tensor, qd: torch.Tensor):
        """COM/contact positions, jacobians and Coriolis terms for a batch,
        q and qd (X, dof). Returns Jc (X,Bo,2,dof), Cc (X,Bo,2),
        cpos (X,C,2), Jp (X,C,2,dof) (planar.py:527-556, batch first)."""
        ang = fixed_sum(q[:, None] * self.G_ang, 2)   # (X, Bo)
        w = fixed_sum(qd[:, None] * self.G_ang, 2)
        c, s = torch.cos(ang), torch.sin(ang)
        ct, st, wt = c[:, self.kin_tb], s[:, self.kin_tb], w[:, self.kin_tb]  # (X, T)
        vx, vz = self.kin_V[:, 0], self.kin_V[:, 1]
        rot = torch.stack([ct * vx + st * vz, -st * vx + ct * vz], -1)        # (X,T,2)
        drot = torch.stack([-st * vx + ct * vz, -ct * vx - st * vz], -1)
        Jo = fixed_sum(drot[:, None, :, :, None] * self.kin_AG, 2)           # (X,Bo,2,dof)
        Jo[:, :, 0, 0] += 1.0
        Jo[:, :, 1, 1] += 1.0
        Co = -fixed_sum(self.kin_A3 * (rot * (wt ** 2)[..., None])[:, None], 2)
        root = torch.stack([q[:, 0], q[:, 1] + self.spec.z_off], -1)          # (X, 2)
        origins = root[:, None] + fixed_sum(self.kin_A3 * rot[:, None], 2)
        rx, rz = self.coms[:, 0], self.coms[:, 1]
        rc = torch.stack([c * rx + s * rz, -s * rx + c * rz], -1)             # (X,Bo,2)
        drc = torch.stack([-s * rx + c * rz, -c * rx - s * rz], -1)
        Jc = Jo + torch.einsum("xbc,bj->xbcj", drc, self.G_ang)
        Cc = Co - rc * (w ** 2)[..., None]
        cb = self.kin_cb
        px, pz = self.cpts[:, 0], self.cpts[:, 1]
        cc, sc = c[:, cb], s[:, cb]
        rp = torch.stack([cc * px + sc * pz, -sc * px + cc * pz], -1)         # (X,C,2)
        drp = torch.stack([-sc * px + cc * pz, -cc * px - sc * pz], -1)
        cpos = origins[:, cb] + rp
        Jp = Jo[:, cb] + torch.einsum("xpc,pj->xpcj", drp, self.kin_Gc)
        return Jc, Cc, cpos, Jp

    def substep(self, q: torch.Tensor, qd: torch.Tensor, tau: torch.Tensor,
                root_force: Optional[torch.Tensor] = None):
        """One implicit-damping Euler substep; q, qd (X, dof), tau (X, n_joints).
        ``root_force`` (X, 2) is an optional external force on the root's
        (x, z), the coupled cheetahs' tendon (planar.py:474-495)."""
        spec = self.spec
        dt = spec.dt
        Jc, Cc, p, Jp = self.kin_analytic(q, qd)
        X, dof = q.shape
        mJ = self.masses[:, None, None] * Jc                                  # (X,Bo,2,dof)
        M = fixed_sum((mJ[..., None] * Jc[..., None, :]).reshape(X, -1, dof, dof), 1)
        M = M + self.M_const
        corio = fixed_sum((mJ * Cc[..., None]).reshape(X, -1, dof), 1)
        Q = -GRAVITY * fixed_sum(mJ[:, :, 1], 1)
        Q = torch.cat([Q[:, :3], Q[:, 3:] + self.gears * tau], dim=1)
        if root_force is not None:
            Q = torch.cat([Q[:, :2] + root_force, Q[:, 2:]], dim=1)
        Q = Q - self.joint_stiff * q
        over = torch.clamp(q - self.q_hi, min=0.0) - torch.clamp(self.q_lo - q, min=0.0)
        outside = (over != 0.0).to(q.dtype)
        Q = Q - spec.limit_stiffness * over
        D = torch.diag_embed(self.joint_damp + spec.limit_damping * outside)
        v = fixed_sum(Jp * qd[:, None, None], 3)                            # (X, C, 2)
        pen = torch.clamp(self.crad - p[:, :, 1], min=0.0)                  # (X, C)
        active = (pen > 0.0).to(q.dtype)
        N = spec.contact_stiffness * pen
        Jn, Jt = Jp[:, :, 1], Jp[:, :, 0]
        Q = Q + fixed_sum(N[..., None] * Jn, 1)
        D = D + spec.contact_damping * torch.einsum("xp,xpi,xpj->xij", active, Jn, Jn)
        ct = self.cmu * N / (torch.abs(v[:, :, 0]) + spec.friction_vreg)
        D = D + torch.einsum("xp,xpi,xpj->xij", ct, Jt, Jt)
        rhs = torch.einsum("xij,xj->xi", M, qd) + dt * (Q - corio)
        qd_new = gauss_solve(M + dt * D, rhs)
        qd_new = torch.clamp(qd_new, -100.0, 100.0)
        return q + dt * qd_new, qd_new

    def physics_step(self, q: torch.Tensor, qd: torch.Tensor, actions: torch.Tensor):
        """frame_skip substeps; actions (X, n_joints) clipped to [-1, 1]."""
        tau = torch.clamp(actions, -1.0, 1.0)
        for _ in range(self.spec.frame_skip):
            q, qd = self.substep(q, qd, tau)
        return q, qd


# ============================================================ the MARL env
class PlanarMAMuJoCo:
    """MAMuJoCo factorization of the planar robot over a batch of envs:
    contiguous actuator partitions by ``agent_conf`` "NxM"; per-agent obs =
    standardized concat(state, one-hot agent id); share_obs = state; team
    reward; truncation at ``episode_limit`` ⇒ ``bad_transition``, unhealthy
    termination (Walker2d, Hopper) ⇒ ``dones`` alone."""

    def __init__(self, dyn: PlanarDynamics, n_agents: int, joints_per_agent: int,
                 episode_limit: int = 1000):
        self.dyn = dyn
        self.n_agents = n_agents
        self.joints_per_agent = joints_per_agent
        self.episode_limit = episode_limit
        self.eye = torch.eye(n_agents, device=dyn.device)

    @property
    def spec(self) -> RobotSpec:
        return self.dyn.spec

    @property
    def device(self) -> torch.device:
        return self.dyn.device

    @property
    def state_dim(self) -> int:
        return self.spec.obs_dim

    @property
    def obs_dim(self) -> int:
        return self.state_dim + self.n_agents

    @property
    def reset_noise_spec(self):
        """qpos's uniforms, then qvel's normals (cheetah) or uniforms."""
        dof = self.spec.dof
        return (("uniform", dof), ("normal" if self.spec.reset_qvel_normal else "uniform", dof))

    @property
    def observation_space(self):
        return [spaces.Box.create(-np.inf, np.inf, self.obs_dim)] * self.n_agents

    @property
    def share_observation_space(self):
        return [spaces.Box.create(-np.inf, np.inf, self.state_dim)] * self.n_agents

    @property
    def action_space(self):
        return [spaces.Box.create(-1.0, 1.0, s) for s in self._agent_sizes()]

    def _agent_sizes(self):
        sizes = [self.joints_per_agent] * self.n_agents
        sizes[-1] += self.spec.n_joints - self.n_agents * self.joints_per_agent
        return sizes

    # ------------------------------------------------------------------ api
    def reset(self, noise: Tuple[torch.Tensor, torch.Tensor]) -> Tuple[PlanarState, TimeStep]:
        """``noise`` = (uniform [0,1), standard normal or uniform [0, 1)),
        each (X, dof), as ``reset_noise_spec`` asks: qpos = qpos0 + U(−a, a),
        qvel = scale·N(0, 1) (cheetah) or U(−scale, scale) (planar.py:647-662)."""
        spec = self.spec
        u, v = noise
        a = spec.reset_qpos_noise
        q0 = torch.zeros(spec.dof, device=self.device)
        q0[1] = spec.qpos0_z
        q = q0 + _uniform(u, a)
        qd = (spec.reset_qvel_noise * v if spec.reset_qvel_normal
              else _uniform(v, spec.reset_qvel_noise))
        t = torch.zeros(q.shape[0], dtype=torch.int32, device=self.device)
        state = PlanarState(q=q, qd=qd, t=t)
        zeros = torch.zeros(q.shape[0], device=self.device)
        no = torch.zeros(q.shape[0], dtype=torch.bool, device=self.device)
        return state, self._timestep(state, zeros, no, no)

    def step(self, state: PlanarState, actions: torch.Tensor) -> Tuple[PlanarState, TimeStep]:
        """actions (X, n_agents, max_act) in [-1, 1]; padding columns dropped."""
        spec = self.spec
        sizes = self._agent_sizes()
        flat = torch.cat([actions[:, i, : sizes[i]] for i in range(self.n_agents)], dim=1)
        q, qd = self.dyn.physics_step(state.q, state.qd, flat)
        vel = (q[:, 0] - state.q[:, 0]) / (spec.dt * spec.frame_skip)
        ctrl = (torch.clamp(flat, -1.0, 1.0) ** 2).sum(dim=1)
        healthy = self._is_healthy(q, qd)
        reward = (spec.forward_reward_weight * vel - spec.ctrl_cost_weight * ctrl
                  + spec.healthy_reward * (healthy.to(q.dtype) if spec.terminate_when_unhealthy
                                           else 1.0))
        new_t = state.t + 1
        trunc = new_t >= self.episode_limit
        term = ~healthy if spec.terminate_when_unhealthy else torch.zeros_like(trunc)
        new_state = PlanarState(q=q, qd=qd, t=new_t)
        return new_state, self._timestep(new_state, reward, term | trunc, trunc & ~term)

    def _is_healthy(self, q: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
        """(X,) bool: torso height and pitch in range, and for the hopper
        every |q[2:]|, |qd| below the state bound (planar.py:688-698)."""
        spec = self.spec
        z = q[:, 1] + (spec.z_off if spec.qpos0_z == 0.0 else 0.0)
        ok = (z > spec.healthy_z_range[0]) & (z < spec.healthy_z_range[1])
        ok = ok & (q[:, 2] > spec.healthy_angle_range[0]) & (q[:, 2] < spec.healthy_angle_range[1])
        if np.isfinite(spec.healthy_state_range[0]):
            sv = torch.cat([q[:, 2:], qd], dim=1)
            ok = ok & (sv.abs() < spec.healthy_state_range[1]).all(dim=1)
        return ok

    # ---------------------------------------------------------- observation
    def _timestep(self, state: PlanarState, reward, done, bad) -> TimeStep:
        X, N = state.q.shape[0], self.n_agents
        qd = state.qd
        if self.spec.clip_qvel_obs > 0:
            qd = torch.clamp(qd, -self.spec.clip_qvel_obs, self.spec.clip_qvel_obs)
        sv = torch.cat([state.q[:, 1:], qd], dim=1)                        # (X, ds)
        obs = torch.cat([sv[:, None].expand(X, N, sv.shape[1]),
                         self.eye.expand(X, N, N)], dim=-1)
        # per-obs standardization with the population std (ddof=0, like
        # jnp.std; mujoco_multi.py:208-211)
        mean = obs.mean(dim=-1, keepdim=True)
        std = obs.std(dim=-1, keepdim=True, correction=0) + 1e-8
        obs = (obs - mean) / std
        return TimeStep(
            obs=obs,
            share_obs=sv,
            rewards=reward[:, None, None].expand(X, N, 1),
            dones=done[:, None].expand(X, N),
            bad_transition=bad,
        )


def _uniform(u: torch.Tensor, a: float) -> torch.Tensor:
    """U(−a, a) from u on [0, 1), as ``jax.random.uniform`` maps it."""
    return torch.clamp(u * (a - (-a)) + (-a), min=-a)


def make_planar(env_args: dict, device: torch.device) -> PlanarMAMuJoCo:
    scenario = env_args.get("scenario", "HalfCheetah-v2")
    base = scenario.split("-")[0]
    if base not in SPECS:
        raise ValueError(f"no planar spec for scenario {scenario!r}; available: "
                         f"{sorted(SPECS)}")
    spec = SPECS[base]
    conf = env_args.get("agent_conf", {"HalfCheetah": "6x1", "Walker2d": "2x3"}.get(base, "3x1"))
    n_agents, joints = (int(x) for x in conf.split("x"))
    if n_agents * joints > spec.n_joints:
        raise ValueError(f"agent_conf {conf} exceeds {spec.n_joints} joints")
    return PlanarMAMuJoCo(
        dyn=PlanarDynamics(spec, device),
        n_agents=n_agents,
        joints_per_agent=joints,
        episode_limit=env_args.get("episode_limit", 1000),
    )
