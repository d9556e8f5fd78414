"""The 3D Humanoid for the port (counterpart of
``harl_tpu/envs/mamujoco_jax/humanoid.py``): MAMuJoCo Humanoid-v2 (17x1,
9|8 and contiguous ``a|b`` splits) and HumanoidStandup-v2, stepped as a
batch of X instances on one device.

    q = (x, y, z, r₁ r₂ r₃, θ₁…θ₁₇)   root position, rotation vector, joints
    p(q) = o + R(r)·u(θ)              41 point masses over humanoid.xml's 13
                                      bodies (capsule ends m/6 and middle
                                      2m/3, spheres at their centre); u is
                                      the point in the root's frame, found by
                                      walking the body tree
    M(q) = Σ mᵢ JᵢᵀJᵢ + diag(armature) + 1e-6·I,  J = ∂p/∂q
    (M + dt·D) q̇′ = M q̇ + dt·(Q − Σ mᵢ Jᵢᵀ a_bias),  a_bias = ∂(J q̇)/∂q · q̇

with joint springs toward qpos0, limits as an explicit spring and an
implicit damper, penalty normal contact on 13 spheres and 2-D regularised
Coulomb friction as an implicit damper, 5 substeps of 0.003 s an env step.
The tables, the reward, the unhealthy termination and the standup variant
are the JAX env's.

Where the JAX env takes J by ``jax.jacfwd`` and a_bias by nested
``jax.jvp``, the port writes both out. In the root's frame a revolute joint
j has the axis κⱼ and the anchor αⱼ; a point u that joint j moves has the
column κⱼ × (u − αⱼ), so u̇ = ω_u × u − Σⱼ θ̇ⱼ κⱼ × αⱼ over its joints, with
ω_u = Σⱼ θ̇ⱼκⱼ. With Ωⱼ = Σ θ̇ᵢκᵢ over the joints that precede j, κ̇ⱼ =
Ωⱼ × κⱼ and α̇ⱼ = Ωⱼ × αⱼ − Σ θ̇ᵢκᵢ × αᵢ, so the root-frame bias is

    ü = Σⱼ θ̇ⱼ [κ̇ⱼ × (u − αⱼ) + κⱼ × (u̇ − α̇ⱼ)],

all of it sums over (X, J, 3) tensors under masks of the tree. The root
columns and terms are the Ant's (``ant.RotvecFrame``): ∂p/∂rᵢ = ∂R/∂rᵢ·u
and a_bias = R̈·u + 2Ṙ·u̇ + R·ü. The 23×23 system is assembled and solved in
float64 (``torch.linalg.solve_ex``) and q̇′ rounded once, as the Ant's is,
and the sums a batched matmul would round by the batch's width on the card
are ``fixed_sum``'s, as the Ant's are.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from harl_tpu_torch.envs.core import TimeStep
from harl_tpu_torch.envs.mamujoco_jax.ant import RotvecFrame, _skew
from harl_tpu_torch.envs.mamujoco_jax.fixed_sum import fixed_sum
from harl_tpu_torch.envs.mamujoco_jax.planar import _uniform
from harl_tpu_torch.utils import spaces

GRAVITY = 9.81
DT = 0.003
FRAME_SKIP = 5
DENSITY = 1000.0
CONTACT_K = 20000.0
CONTACT_C = 300.0
FRICTION_MU = 1.0
FRICTION_VREG = 0.1
LIMIT_K = 600.0
LIMIT_C = 20.0
CTRL_RANGE = 0.4
CTRL_COST = 0.1
CONTACT_COST = 5e-7
CONTACT_COST_MAX = 10.0
HEALTHY_REWARD = 5.0
FORWARD_WEIGHT = 1.25
HEALTHY_Z = (1.0, 2.0)
ROTVEC_MAX = 1.9 * math.pi
TORSO_Z0 = 1.4
RESET_NOISE = 0.01

D2R = math.pi / 180.0


def _norm(v):
    n = math.sqrt(sum(x * x for x in v))
    return tuple(x / n for x in v)


# humanoid.xml. Joint order = actuator order:
JOINTS = [
    # (name, body, axis, anchor, range_deg, armature, damping, stiffness, gear)
    ("abdomen_y", "lwaist", (0, 1, 0), (0, 0, 0.065), (-75, 30), 0.02, 5, 10, 100),
    ("abdomen_z", "lwaist", (0, 0, 1), (0, 0, 0.065), (-45, 45), 0.02, 5, 20, 100),
    ("abdomen_x", "pelvis", (1, 0, 0), (0, 0, 0.1), (-35, 35), 0.02, 5, 10, 100),
    ("right_hip_x", "right_thigh", (1, 0, 0), (0, 0, 0), (-25, 5), 0.01, 5, 10, 100),
    ("right_hip_z", "right_thigh", (0, 0, 1), (0, 0, 0), (-60, 35), 0.01, 5, 10, 100),
    ("right_hip_y", "right_thigh", (0, 1, 0), (0, 0, 0), (-110, 20), 0.008, 5, 20, 300),
    ("right_knee", "right_shin", (0, -1, 0), (0, 0, 0.02), (-160, -2), 0.006, 1, 0, 200),
    ("left_hip_x", "left_thigh", (-1, 0, 0), (0, 0, 0), (-25, 5), 0.01, 5, 10, 100),
    ("left_hip_z", "left_thigh", (0, 0, -1), (0, 0, 0), (-60, 35), 0.01, 5, 10, 100),
    ("left_hip_y", "left_thigh", (0, 1, 0), (0, 0, 0), (-110, 20), 0.01, 5, 20, 300),
    ("left_knee", "left_shin", (0, -1, 0), (0, 0, 0.02), (-160, -2), 0.006, 1, 1, 200),
    ("right_shoulder1", "right_upper_arm", _norm((2, 1, 1)), (0, 0, 0), (-85, 60), 0.0068, 1, 1, 25),
    ("right_shoulder2", "right_upper_arm", _norm((0, -1, 1)), (0, 0, 0), (-85, 60), 0.0051, 1, 1, 25),
    ("right_elbow", "right_lower_arm", _norm((0, -1, 1)), (0, 0, 0), (-90, 50), 0.0028, 1, 0, 25),
    ("left_shoulder1", "left_upper_arm", _norm((2, -1, 1)), (0, 0, 0), (-60, 85), 0.0068, 1, 1, 25),
    ("left_shoulder2", "left_upper_arm", _norm((0, 1, 1)), (0, 0, 0), (-60, 85), 0.0051, 1, 1, 25),
    ("left_elbow", "left_lower_arm", _norm((0, -1, -1)), (0, 0, 0), (-90, 50), 0.0028, 1, 0, 25),
]
N_JOINTS = len(JOINTS)
DOF = 6 + N_JOINTS

# (name, parent, pos): parents precede children
BODIES = [
    ("torso", None, (0, 0, 0)),
    ("lwaist", "torso", (-0.01, 0, -0.26)),
    ("pelvis", "lwaist", (0, 0, -0.165)),
    ("right_thigh", "pelvis", (0, -0.1, -0.04)),
    ("right_shin", "right_thigh", (0, 0.01, -0.403)),
    ("right_foot", "right_shin", (0, 0, -0.45)),
    ("left_thigh", "pelvis", (0, 0.1, -0.04)),
    ("left_shin", "left_thigh", (0, -0.01, -0.403)),
    ("left_foot", "left_shin", (0, 0, -0.45)),
    ("right_upper_arm", "torso", (0, -0.17, 0.06)),
    ("right_lower_arm", "right_upper_arm", (0.18, -0.18, -0.18)),
    ("left_upper_arm", "torso", (0, 0.17, 0.06)),
    ("left_lower_arm", "left_upper_arm", (0.18, 0.18, -0.18)),
]

# geoms: (body, kind, a, b_or_None, radius)
GEOMS = [
    ("torso", "cap", (0, -0.07, 0), (0, 0.07, 0), 0.07),
    ("torso", "sph", (0, 0, 0.19), None, 0.09),                       # head
    ("torso", "cap", (-0.01, -0.06, -0.12), (-0.01, 0.06, -0.12), 0.06),
    ("lwaist", "cap", (0, -0.06, 0), (0, 0.06, 0), 0.06),
    ("pelvis", "cap", (-0.02, -0.07, 0), (-0.02, 0.07, 0), 0.09),     # butt
    ("right_thigh", "cap", (0, 0, 0), (0, 0.01, -0.34), 0.06),
    ("right_shin", "cap", (0, 0, 0), (0, 0, -0.3), 0.049),
    ("right_foot", "sph", (0, 0, 0.1), None, 0.075),
    ("left_thigh", "cap", (0, 0, 0), (0, -0.01, -0.34), 0.06),
    ("left_shin", "cap", (0, 0, 0), (0, 0, -0.3), 0.049),
    ("left_foot", "sph", (0, 0, 0.1), None, 0.075),
    ("right_upper_arm", "cap", (0, 0, 0), (0.16, -0.16, -0.16), 0.04),
    ("right_lower_arm", "cap", (0.01, 0.01, 0.01), (0.17, 0.17, 0.17), 0.031),
    ("right_lower_arm", "sph", (0.18, 0.18, 0.18), None, 0.04),       # hand
    ("left_upper_arm", "cap", (0, 0, 0), (0.16, 0.16, -0.16), 0.04),
    ("left_lower_arm", "cap", (0.01, -0.01, 0.01), (0.17, -0.17, 0.17), 0.031),
    ("left_lower_arm", "sph", (0.18, -0.18, 0.18), None, 0.04),       # hand
]

# contact spheres: (body, local pos, radius): extremities and trunk
CONTACT_SPHERES = [
    ("right_foot", (0, 0, 0.1), 0.075),
    ("left_foot", (0, 0, 0.1), 0.075),
    ("right_lower_arm", (0.18, 0.18, 0.18), 0.04),
    ("left_lower_arm", (0.18, -0.18, 0.18), 0.04),
    ("torso", (0, 0, 0.19), 0.09),                   # head
    ("torso", (0, -0.07, 0), 0.07),
    ("torso", (0, 0.07, 0), 0.07),
    ("pelvis", (-0.02, -0.07, 0), 0.09),
    ("pelvis", (-0.02, 0.07, 0), 0.09),
    ("right_shin", (0, 0, 0), 0.049),                # knees
    ("left_shin", (0, 0, 0), 0.049),
    ("right_upper_arm", (0.16, -0.16, -0.16), 0.04),  # elbows
    ("left_upper_arm", (0.16, 0.16, -0.16), 0.04),
]

_BODY_IDX = {name: i for i, (name, _, _) in enumerate(BODIES)}
_BODY_JOINTS = {name: [j for j, row in enumerate(JOINTS) if row[1] == name]
                for name, _, _ in BODIES}


def _cap_mass(a, b, r):
    return DENSITY * (math.pi * r * r * math.dist(a, b) + (4.0 / 3.0) * math.pi * r ** 3)


def _sph_mass(r):
    return DENSITY * (4.0 / 3.0) * math.pi * r ** 3


def _mass_points():
    """Per point mass (the JAX ``_points`` order): its body, its offset in
    the body's frame and its mass."""
    body, w, m = [], [], []
    for name, kind, a, b, r in GEOMS:
        if kind == "sph":
            body.append(_BODY_IDX[name])
            w.append(a)
            m.append(_sph_mass(r))
        else:
            mc = _cap_mass(a, b, r)
            mid = tuple(0.5 * (x + y) for x, y in zip(a, b))
            for v, mass in ((a, mc / 6), (mid, 2 * mc / 3), (b, mc / 6)):
                body.append(_BODY_IDX[name])
                w.append(v)
                m.append(mass)
    return np.array(body), np.array(w, np.float64), np.array(m, np.float64)


PT_BODY, PT_LOCAL, PT_MASS = _mass_points()
TOTAL_MASS = float(np.sum(PT_MASS.astype(np.float32)))    # the JAX env's float32 sum
Q_LO = np.array([row[4][0] * D2R for row in JOINTS])
Q_HI = np.array([row[4][1] * D2R for row in JOINTS])


def _ancestors(body: str):
    out = []
    while body is not None:
        out.append(body)
        body = BODIES[_BODY_IDX[body]][1]
    return out


def _moves(bodies) -> np.ndarray:
    """(len(bodies), J): 1 where joint j moves a point of that body."""
    return np.array([[float(JOINTS[j][1] in _ancestors(b)) for j in range(N_JOINTS)]
                     for b in bodies])


def _precedes() -> np.ndarray:
    """(J, J): S[j, i] = 1 where joint i turns the frame joint j sits in:
    a joint of an ancestor body, or an earlier joint of the same body."""
    S = np.zeros((N_JOINTS, N_JOINTS))
    for j, row in enumerate(JOINTS):
        for i, other in enumerate(JOINTS):
            if other[1] == row[1]:
                S[j, i] = float(i < j)
            else:
                S[j, i] = float(other[1] in _ancestors(row[1]))
    return S


class HumanoidState(NamedTuple):
    q: torch.Tensor    # (X, 23)
    qd: torch.Tensor   # (X, 23)
    t: torch.Tensor    # (X,) int32


class HumanoidDynamics:
    """The batched humanoid physics on ``device``; ``vreg`` is the friction's
    regularising speed."""

    def __init__(self, device: torch.device, vreg: float = FRICTION_VREG):
        self.device = device
        self.vreg = vreg
        f = self._const
        # the physics' points: the 41 masses, then the 13 contact spheres
        bodies = np.concatenate([PT_BODY, [_BODY_IDX[b] for b, _, _ in CONTACT_SPHERES]])
        self.pt_body = torch.as_tensor(bodies, device=device)
        self.pt_local = f(np.concatenate([PT_LOCAL, [p for _, p, _ in CONTACT_SPHERES]]))
        self.pt_moves = f(_moves([BODIES[b][0] for b in bodies]))
        self.n_mass = len(PT_MASS)
        self.masses = f(PT_MASS)
        self.contact_radii = f([r for _, _, r in CONTACT_SPHERES])
        # the joints' body origins (the local observations)
        self.joint_body = torch.as_tensor([_BODY_IDX[row[1]] for row in JOINTS], device=device)
        self.origin_moves = f(_moves([row[1] for row in JOINTS]))
        self.precedes = f(_precedes())
        axes = np.array([np.asarray(row[2], np.float64) / np.linalg.norm(row[2])
                         for row in JOINTS])
        self.axis = f(axes)
        self.anchor = f([row[3] for row in JOINTS])
        self.k1 = f(np.stack([_skew(k) for k in axes]))
        self.k2 = f(np.stack([_skew(k) @ _skew(k) for k in axes]))
        self.gears = f([row[8] for row in JOINTS])
        self.stiffness = f([row[7] for row in JOINTS])
        self.dampings = f([row[6] for row in JOINTS])
        self.q_lo, self.q_hi = f(Q_LO), f(Q_HI)
        self.q0 = torch.clamp(torch.zeros(N_JOINTS, device=device), self.q_lo, self.q_hi)
        self.diag_m = torch.cat([torch.zeros(6, device=device),
                                 f([row[5] for row in JOINTS])]).double() + 1e-6
        self.root = RotvecFrame(device)
        self.eye3 = torch.eye(3, device=device)
        self.body_pos = [f(pos) for _, _, pos in BODIES]

    def _const(self, x) -> torch.Tensor:
        """float64 numpy → float32, as the JAX package stores it."""
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    # --------------------------------------------------------- kinematics
    def chain(self, q: torch.Tensor):
        """The body frames in the root's frame, origins (X, B, 3) and
        rotations (X, B, 3, 3), and each joint's axis κ and anchor α (X, J, 3)
        there: the tree walk of the JAX ``_body_frames``."""
        X = q.shape[0]
        th = q[:, 6:, None, None]
        rj = self.eye3 + torch.sin(th) * self.k1 + (1.0 - torch.cos(th)) * self.k2   # (X, J, 3, 3)
        # a joint moves its frame's origin O to O + R·(a − R_j·a)
        shift = self.anchor - torch.einsum("xjab,jb->xja", rj, self.anchor)
        zero = torch.zeros(X, 3, device=q.device)
        frames, before = {}, {}
        for name, parent, _ in BODIES:
            if parent is None:
                O, R = zero, self.eye3.expand(X, 3, 3)
            else:
                Op, R = frames[parent]
                O = Op + fixed_sum(R * self.body_pos[_BODY_IDX[name]], 2)
            for j in _BODY_JOINTS[name]:
                before[j] = (O, R)
                O = O + (R @ shift[:, j, :, None])[..., 0]
                R = R @ rj[:, j]
            frames[name] = (O, R)
        O_b = torch.stack([frames[n][0] for n, _, _ in BODIES], dim=1)
        R_b = torch.stack([frames[n][1] for n, _, _ in BODIES], dim=1)
        O_j = torch.stack([before[j][0] for j in range(N_JOINTS)], dim=1)
        R_j = torch.stack([before[j][1] for j in range(N_JOINTS)], dim=1)
        kappa = fixed_sum(R_j * self.axis[:, None], 3)
        alpha = O_j + torch.einsum("xjab,jb->xja", R_j, self.anchor)
        return O_b, R_b, kappa, alpha

    def kinematics(self, q: torch.Tensor, qd: torch.Tensor, bodies=None, local=None,
                   moves=None, bias: bool = True):
        """World positions p (X, P, 3), J = ∂p/∂q (X, P, 3, 23) and, with
        ``bias``, a_bias = ∂(J q̇)/∂q · q̇ (X, P, 3) of points fixed in
        ``bodies`` at ``local`` offsets (the physics' points by default) for
        q, q̇ (X, 23)."""
        if bodies is None:
            bodies, local, moves = self.pt_body, self.pt_local, self.pt_moves
        X = q.shape[0]
        O_b, R_b, kappa, alpha = self.chain(q)
        u = O_b[:, bodies] + fixed_sum(R_b[:, bodies] * local[:, None], 3)        # root frame
        R, dR, Rdd = self.root(q[:, 3:6], qd[:, 3:6])
        w = qd[:, 6:, None] * kappa                                    # θ̇ⱼκⱼ
        w_a = torch.linalg.cross(w, alpha)
        omega = moves @ w                                               # ω_u (X, P, 3)
        udot = torch.linalg.cross(omega, u) - moves @ w_a
        col = torch.linalg.cross(kappa[:, None], u[:, :, None])
        col = (col - torch.linalg.cross(kappa, alpha)[:, None]) * moves[:, :, None]   # (X, P, J, 3)
        p = q[:, None, 0:3] + torch.einsum("xab,xpb->xpa", R, u)
        j_rot = torch.einsum("xiab,xpb->xpai", dR, u)
        j_joint = torch.einsum("xab,xpjb->xpaj", R, col)
        J = torch.cat([self.eye3.expand(X, u.shape[1], 3, 3), j_rot, j_joint], dim=-1)
        if not bias:
            return p, J, None
        big = self.precedes @ w                                         # Ωⱼ
        g = qd[:, 6:, None] * torch.linalg.cross(big, kappa)            # θ̇ⱼκ̇ⱼ
        adot = torch.linalg.cross(big, alpha) - self.precedes @ w_a     # α̇ⱼ
        uddot = (torch.linalg.cross(moves @ g, u) - moves @ torch.linalg.cross(g, alpha)
                 + torch.linalg.cross(omega, udot) - moves @ torch.linalg.cross(w, adot))
        Rd = fixed_sum(dR * qd[:, 3:6, None, None], 1)
        rot = lambda m, v: torch.einsum("xab,xpb->xpa", m, v)
        a_bias = rot(Rdd, u) + 2.0 * rot(Rd, udot) + rot(R, uddot)
        return p, J, a_bias

    def positions(self, q: torch.Tensor) -> torch.Tensor:
        """The mass points' world positions (X, 41, 3) at q."""
        O_b, R_b, _, _ = self.chain(q)
        nm = self.n_mass
        u = O_b[:, self.pt_body[:nm]] + fixed_sum(R_b[:, self.pt_body[:nm]]
                                                  * self.pt_local[:nm, None], 3)
        R = self.root.rotation(q[:, 3:6])
        return q[:, None, 0:3] + torch.einsum("xab,xpb->xpa", R, u)

    def mass_matrix(self, J: torch.Tensor) -> torch.Tensor:
        """Σ mᵢ JᵢᵀJᵢ + diag(armature) + 1e-6·I (X, 23, 23) over the mass
        points' rows of J, in float64."""
        J = J[:, :self.n_mass].double()
        return (torch.einsum("p,xpci,xpcj->xij", self.masses.double(), J, J)
                + torch.diag(self.diag_m))

    def substep(self, q: torch.Tensor, qd: torch.Tensor, tau: torch.Tensor):
        """One implicit-damping Euler substep; returns (q′, q̇′, Σ normal
        forces, the mass points' positions at q) (humanoid.py:243-283)."""
        p, J, a_bias = self.kinematics(q, qd)
        nm = self.n_mass
        Jc, cpos = J[:, nm:], p[:, nm:]
        v = torch.einsum("xpcj,xj->xpc", Jc, qd)
        pen = torch.clamp(self.contact_radii - cpos[..., 2], min=0.0)
        N = CONTACT_K * pen
        vt = torch.sqrt(v[..., 0] ** 2 + v[..., 1] ** 2) + self.vreg
        ct = FRICTION_MU * N / vt
        qj = q[:, 6:]
        over = torch.clamp(qj - self.q_hi, min=0.0) - torch.clamp(self.q_lo - qj, min=0.0)
        outside = (over != 0.0).to(q.dtype)
        joint_q = self.gears * tau - self.stiffness * (qj - self.q0) - LIMIT_K * over
        # float64 from here to the solve
        m = self.masses.double()
        M = self.mass_matrix(J)
        Jm, Jc = J[:, :nm].double(), Jc.double()
        X, dof = q.shape
        mJ = m[:, None, None] * Jm                                        # (X, P, 3, dof)
        corio = fixed_sum((mJ * a_bias[:, :nm, :, None].double()).reshape(X, -1, dof), 1)
        Q = -GRAVITY * fixed_sum(mJ[:, :, 2], 1)
        Q = torch.cat([Q[:, :6], Q[:, 6:] + joint_q.double()], dim=1)
        d_joint = (self.dampings + LIMIT_C * outside).double()
        D = torch.diag_embed(torch.cat([torch.zeros_like(d_joint[:, :6]), d_joint], dim=1))
        # ground contacts: penalty normal + implicit 2-D Coulomb friction
        Jz = Jc[:, :, 2]
        Q = Q + fixed_sum(N.double()[..., None] * Jz, 1)
        D = D + CONTACT_C * torch.einsum("xp,xpi,xpj->xij", (pen > 0.0).double(), Jz, Jz)
        D = D + torch.einsum("xp,xpci,xpcj->xij", ct.double(), Jc[:, :, :2], Jc[:, :, :2])
        rhs = fixed_sum(M * qd.double()[:, None], 2) + DT * (Q - corio)
        qd_new = torch.linalg.solve_ex(M + DT * D, rhs)[0].float()
        qd_new = torch.clamp(qd_new, -100.0, 100.0)
        return q + DT * qd_new, qd_new, N.sum(dim=1), p[:, :nm]

    def com_x(self, p: torch.Tensor) -> torch.Tensor:
        """The centre of mass's x of the mass points' positions (X, 41, 3)."""
        return (self.masses * p[..., 0]).sum(dim=1) / TOTAL_MASS

    def physics_step(self, q: torch.Tensor, qd: torch.Tensor, actions: torch.Tensor):
        """FRAME_SKIP substeps; returns (q, q̇, normal force averaged over
        them, the centre of mass's x at the first q)."""
        tau = torch.clamp(actions, -CTRL_RANGE, CTRL_RANGE)
        n_total = torch.zeros_like(q[:, 0])
        com0 = None
        for _ in range(FRAME_SKIP):
            q, qd, n, p = self.substep(q, qd, tau)
            n_total = n_total + n
            com0 = self.com_x(p) if com0 is None else com0
        return q, qd, n_total / FRAME_SKIP, com0


# reference obsk.py 9|8: agent 0 = upper body (abdomen + shoulders/elbows),
# agent 1 = lower body (hips/knees)
_JOINT_IDX = {name: i for i, (name, *_rest) in enumerate(JOINTS)}
_PART_9_8 = (
    tuple(_JOINT_IDX[n] for n in (
        "abdomen_y", "abdomen_z", "abdomen_x",
        "right_shoulder1", "right_shoulder2", "right_elbow",
        "left_shoulder1", "left_shoulder2", "left_elbow")),
    tuple(_JOINT_IDX[n] for n in (
        "right_hip_x", "right_hip_z", "right_hip_y", "right_knee",
        "left_hip_x", "left_hip_z", "left_hip_y", "left_knee")),
)


def _parse_conf(conf: str):
    """'17x1' → 17 one-joint agents; '9|8' → the upper/lower body split;
    'a|b|…' → contiguous actuator slices. Per-agent lists of joint indices."""
    if conf == "9|8":
        groups = [list(g) for g in _PART_9_8]
    elif "|" in conf:
        sizes = [int(x) for x in conf.split("|")]
        starts = [sum(sizes[:i]) for i in range(len(sizes))]
        groups = [list(range(s, s + sz)) for s, sz in zip(starts, sizes)]
    else:
        n, per = (int(x) for x in conf.split("x"))
        groups = [list(range(i * per, (i + 1) * per)) for i in range(n)]
    if sorted(j for g in groups for j in g) != list(range(N_JOINTS)):
        raise ValueError(f"agent_conf {conf!r} must partition {N_JOINTS} joints")
    return groups


class HumanoidMAMuJoCo:
    """MAMuJoCo Humanoid-v2 over a batch of envs (``standup``: the
    HumanoidStandup-v2 task). Per-agent obs = concat(state, one-hot agent id),
    standardised per row or, with ``obs_standardize`` false, velocities
    scaled by 0.1; with ``agent_obsk`` set, each agent sees only its own
    joints' 11 local features. share_obs = state (44); team reward;
    truncation at ``episode_limit`` ⇒ ``bad_transition``, unhealthy
    termination (not in standup) ⇒ ``dones`` alone."""

    LOCAL_FEATS_PER_JOINT = 11

    def __init__(self, agent_joints=tuple((i,) for i in range(N_JOINTS)),
                 episode_limit: int = 1000, standup: bool = False,
                 friction_vreg: float = FRICTION_VREG, agent_obsk=None,
                 obs_standardize: bool = True, device: torch.device = torch.device("cpu")):
        self.agent_joints = tuple(tuple(g) for g in agent_joints)
        self.episode_limit = episode_limit
        self.standup = standup
        self.agent_obsk = agent_obsk
        self.obs_standardize = obs_standardize
        self.device = torch.device(device)
        self.dyn = HumanoidDynamics(self.device, friction_vreg)
        order = [j for g in self.agent_joints for j in g]
        self.unflatten = torch.as_tensor(np.argsort(order), device=self.device)
        self.eye = torch.eye(self.n_agents, device=self.device)
        self.base = torch.zeros(DOF, device=self.device)
        if standup:   # lying on the back (pitch −π/2), pelvis-height root
            self.base[2], self.base[4] = 0.28, -0.5 * math.pi
        else:
            self.base[2] = TORSO_Z0
        self.base[6:] = self.dyn.q0
        self.obs_scale = torch.cat([torch.ones(DOF - 2), torch.full((DOF,), 0.1),
                                    torch.ones(self.n_agents)]).to(self.device)
        max_j = max(len(g) for g in self.agent_joints)
        # each agent's joints' feature rows, padded with a zero row (index J)
        self.local_rows = torch.as_tensor(
            [list(g) + [N_JOINTS] * (max_j - len(g)) for g in self.agent_joints],
            device=self.device)

    @property
    def n_agents(self) -> int:
        return len(self.agent_joints)

    @property
    def state_dim(self) -> int:
        return (DOF - 2) + DOF

    @property
    def obs_dim(self) -> int:
        if self.agent_obsk is not None:
            return self.LOCAL_FEATS_PER_JOINT * max(len(g) for g in self.agent_joints)
        return self.state_dim + self.n_agents

    @property
    def reset_noise_spec(self):
        """qpos's uniforms, then qvel's."""
        return (("uniform", DOF), ("uniform", DOF))

    @property
    def observation_space(self):
        if self.agent_obsk is not None:
            return [spaces.Box.create(-np.inf, np.inf, self.LOCAL_FEATS_PER_JOINT * len(g))
                    for g in self.agent_joints]
        return [spaces.Box.create(-np.inf, np.inf, self.obs_dim)] * self.n_agents

    @property
    def share_observation_space(self):
        return [spaces.Box.create(-np.inf, np.inf, self.state_dim)] * self.n_agents

    @property
    def action_space(self):
        return [spaces.Box.create(-CTRL_RANGE, CTRL_RANGE, len(g)) for g in self.agent_joints]

    # ------------------------------------------------------------------ api
    def reset(self, noise: Tuple[torch.Tensor, torch.Tensor]) -> Tuple[HumanoidState, TimeStep]:
        """``noise`` = two uniforms on [0, 1), each (X, 23): q = base +
        U(−0.01, 0.01), q̇ = U(−0.01, 0.01) (humanoid.py:384-397)."""
        u1, u2 = noise
        q = self.base + _uniform(u1, RESET_NOISE)
        qd = _uniform(u2, RESET_NOISE)
        X = q.shape[0]
        state = HumanoidState(q=q, qd=qd, t=torch.zeros(X, dtype=torch.int32, device=self.device))
        no = torch.zeros(X, dtype=torch.bool, device=self.device)
        return state, self._timestep(state, torch.zeros(X, device=self.device), no, no)

    def step(self, state: HumanoidState, actions: torch.Tensor):
        """actions (X, n_agents, max_act); each agent's first len(joints)
        columns drive its joints (humanoid.py:399-433)."""
        flat = torch.cat([actions[:, i, :len(g)] for i, g in enumerate(self.agent_joints)],
                         dim=1)[:, self.unflatten]
        q, qd, contact_n, com0 = self.dyn.physics_step(state.q, state.qd, flat)
        a = torch.clamp(flat, -CTRL_RANGE, CTRL_RANGE)
        ctrl = CTRL_COST * (a ** 2).sum(dim=1)
        impact = torch.clamp(CONTACT_COST * contact_n ** 2, max=CONTACT_COST_MAX)
        if self.standup:
            reward = q[:, 2] / DT - ctrl - impact + 1.0
            term = torch.zeros_like(q[:, 0], dtype=torch.bool)
        else:
            vel_x = (self.dyn.com_x(self.dyn.positions(q)) - com0) / (DT * FRAME_SKIP)
            healthy = self._is_healthy(q, qd)
            reward = (FORWARD_WEIGHT * vel_x + HEALTHY_REWARD * healthy.to(q.dtype)
                      - ctrl - impact)
            term = ~healthy
        new_t = state.t + 1
        trunc = new_t >= self.episode_limit
        new_state = HumanoidState(q=q, qd=qd, t=new_t)
        return new_state, self._timestep(new_state, reward, term | trunc, trunc & ~term)

    def _is_healthy(self, q: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
        ok = (q[:, 2] > HEALTHY_Z[0]) & (q[:, 2] < HEALTHY_Z[1])
        ok = ok & (torch.linalg.vector_norm(q[:, 3:6], dim=1) < ROTVEC_MAX)
        return ok & torch.isfinite(q).all(dim=1) & torch.isfinite(qd).all(dim=1)

    # ---------------------------------------------------------- observation
    def _local_obs(self, state: HumanoidState) -> torch.Tensor:
        """(X, N, 11·max joints): per joint its angle, 0.1·velocity, its
        body's height, xy relative to the root, 0.1·world velocity and
        z-axis (humanoid.py:446-472)."""
        q, qd = state.q, state.qd
        X, dyn = q.shape[0], self.dyn
        zeros = torch.zeros(N_JOINTS, 3, device=self.device)
        O, J, _ = dyn.kinematics(q, qd, dyn.joint_body, zeros, dyn.origin_moves, bias=False)
        dO = torch.einsum("xpcj,xj->xpc", J, qd)
        _, R_b, _, _ = dyn.chain(q)
        R = dyn.root.rotation(q[:, 3:6])
        Rz = torch.einsum("xab,xjb->xja", R, R_b[:, dyn.joint_body, :, 2])
        feats = torch.cat([q[:, 6:, None], 0.1 * qd[:, 6:, None], O[..., 2:3],
                           O[..., :2] - q[:, None, :2], 0.1 * dO, Rz], dim=2)   # (X, J, 11)
        feats = torch.cat([feats, torch.zeros_like(feats[:, :1])], dim=1)
        return feats[:, self.local_rows].reshape(X, self.n_agents, -1)

    def _timestep(self, state: HumanoidState, reward, done, bad) -> TimeStep:
        X, N = state.q.shape[0], self.n_agents
        sv = torch.cat([state.q[:, 2:], state.qd], dim=1)                   # (X, 44)
        if self.agent_obsk is not None:
            obs = self._local_obs(state)
        else:
            obs = torch.cat([sv[:, None].expand(X, N, sv.shape[1]), self.eye.expand(X, N, N)],
                            dim=-1)
            if self.obs_standardize:   # the population std, like jnp.std
                mean = obs.mean(dim=-1, keepdim=True)
                obs = (obs - mean) / (obs.std(dim=-1, keepdim=True, correction=0) + 1e-8)
            else:
                obs = obs * self.obs_scale
        return TimeStep(
            obs=obs,
            share_obs=sv,
            rewards=reward[:, None, None].expand(X, N, 1),
            dones=done[:, None].expand(X, N),
            bad_transition=bad,
        )


def make_humanoid(env_args: dict, device: torch.device) -> HumanoidMAMuJoCo:
    scenario = env_args.get("scenario", "Humanoid-v2")
    return HumanoidMAMuJoCo(
        agent_joints=_parse_conf(env_args.get("agent_conf", "17x1")),
        episode_limit=env_args.get("episode_limit", 1000),
        standup=scenario.startswith("HumanoidStandup"),
        obs_standardize=env_args.get("obs_standardize", True),
        friction_vreg=env_args.get("friction_vreg", FRICTION_VREG),
        agent_obsk=env_args.get("agent_obsk", None),
        device=device,
    )
