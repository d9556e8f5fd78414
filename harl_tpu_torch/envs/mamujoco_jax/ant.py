"""The 3D Ant for the port (counterpart of ``harl_tpu/envs/mamujoco_jax/ant.py``):
MAMuJoCo's Ant-v2 2x4 / 4x2 / 8x1 scenarios, stepped as a batch of X
instances on one device.

    q = (x, y, z, r₁ r₂ r₃, θ₁…θ₈)   root position, rotation vector, joints
    p(q) = o + R(r)·w(θ)             43 point masses over the torso→hip→ankle
                                     tree (rod ends m/6 and middle 2m/3,
                                     torso sphere centre 0.4m and 6 surface
                                     points m/10), R by Rodrigues' formula
    M(q) = Σ mᵢ JᵢᵀJᵢ + diag(armature) + 1e-8·I,  J = ∂p/∂q
    (M + dt·D) q̇′ = M q̇ + dt·(Q − Σ mᵢ Jᵢᵀ a_bias),  a_bias = ∂(J q̇)/∂q · q̇

with joint limits as an explicit spring and an implicit damper, penalty
normal contact on five spheres (the torso and the four feet) and 2-D
regularised Coulomb friction as an implicit damper, 5 substeps of 0.01 s an
env step. Geometry, masses, limits, gear, reset noise, the reward and the
unhealthy termination are the JAX env's.

Where the JAX env takes J by ``jax.jacfwd`` and a_bias by nested
``jax.jvp``, the port writes both out. Every point is o + R·w with
w = a + R_z(θ_hip)·b + R_z(θ_hip)·R_axis(θ_ankle)·c for constant a, b, c of
its body, so ∂p/∂o = I, ∂p/∂rᵢ = (∂R/∂rᵢ)·w, ∂p/∂θ = R·∂w/∂θ, and
a_bias = R̈·w + 2Ṙ·ẇ + R·ẅ along q̇. R = I + α(s)[r]ₓ + β(s)[r]ₓ² with
s = r·r + 1e-12, α = sin θ/θ, β = (1 − cos θ)/θ², θ = √s; α, β and their
first two derivatives in s are formed in float64 (series below θ = 1e-2,
where the closed forms cancel) and rounded to float32. Below θ = 1e-4,
R = I + [r]ₓ as in the JAX env's blend. The 14×14 system is assembled and
solved (``torch.linalg.solve_ex``, which does not wait on the device) in
float64 (``substep``). Constants are computed in float64 with numpy and
stored in float32; the rest of the arithmetic is float32, so the port
agrees with the JAX env to float32 rounding. The sums over the points, the
contacts and the rotations' axes that a batched matmul would round by the
batch's width on the card are ``fixed_sum``'s.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from harl_tpu_torch.envs.core import TimeStep
from harl_tpu_torch.envs.mamujoco_jax.fixed_sum import fixed_sum
from harl_tpu_torch.envs.mamujoco_jax.planar import _uniform
from harl_tpu_torch.utils import spaces

GRAVITY = 9.81
DT = 0.01
FRAME_SKIP = 5
GEAR = 150.0
ARMATURE = 1.0
JOINT_DAMPING = 1.0
DENSITY = 5.0
TORSO_R = 0.25
CAP_R = 0.08
L_LINK = 0.2 * math.sqrt(2.0)    # aux geom |(0.2, 0.2, 0)|
L_UPPER = 0.2 * math.sqrt(2.0)   # leg geom
L_LOWER = 0.4 * math.sqrt(2.0)   # ankle geom
QPOS0_Z = 0.75
RESET_NOISE = 0.1
CONTACT_K = 1500.0
CONTACT_C = 40.0
FRICTION_MU = 1.0
FRICTION_VREG = 0.1
LIMIT_K = 300.0
LIMIT_C = 10.0
CTRL_COST = 0.5
CONTACT_COST = 5e-4
HEALTHY_REWARD = 1.0
HEALTHY_Z = (0.2, 1.0)
ROTVEC_MAX = 1.9 * math.pi       # chart-safety termination

# legs in ant.xml body order 1..4: azimuths of (0.2,0.2), (-0.2,0.2),
# (-0.2,-0.2), (0.2,-0.2)
LEG_PHI = (45.0, 135.0, 225.0, 315.0)
# actuator order (ant.xml <actuator>): hip_4, ankle_4, hip_1, ankle_1,
# hip_2, ankle_2, hip_3, ankle_3 → (leg index, is_ankle)
ACTUATORS = ((3, 0), (3, 1), (0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1))
HIP_RANGE = (-math.radians(30.0), math.radians(30.0))
ANKLE_RANGE = {  # per leg, radians (ant.xml ankle_1..4)
    0: (math.radians(30.0), math.radians(70.0)),
    1: (-math.radians(70.0), -math.radians(30.0)),
    2: (-math.radians(70.0), -math.radians(30.0)),
    3: (math.radians(30.0), math.radians(70.0)),
}
# ankle rotation axes in the hip frame (ant.xml, normalised below)
ANKLE_AXIS = {0: (-1.0, 1.0, 0.0), 1: (1.0, 1.0, 0.0), 2: (-1.0, 1.0, 0.0), 3: (1.0, 1.0, 0.0)}

DOF = 14                          # 3 pos + 3 rotvec + 8 joints
N_JOINTS = 8
# q index of each leg's hip and ankle under the actuator ordering
Q_HIP = tuple(6 + ACTUATORS.index((leg, 0)) for leg in range(4))
Q_ANKLE = tuple(6 + ACTUATORS.index((leg, 1)) for leg in range(4))


def _capsule_mass(length: float) -> float:
    r = CAP_R
    return DENSITY * (math.pi * r * r * length + (4.0 / 3.0) * math.pi * r ** 3)


M_SPH = DENSITY * (4.0 / 3.0) * math.pi * TORSO_R ** 3
M_LINK, M_UP, M_LOW = (_capsule_mass(x) for x in (L_LINK, L_UPPER, L_LOWER))


def _skew(k) -> np.ndarray:
    return np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])


class LeggedBody(NamedTuple):
    """A rigid root with legs of a z hip and an ankle about a fixed axis,
    as point tables: per point (the JAX ``_points`` order) its leg, the
    constant vectors a, b, c of w = a + R_z(θ_hip)·b + R_z·R_axis(θ_ankle)·c
    and its mass; per leg its hip and ankle q index and ankle axis; the
    contact points (indices) and radii; per joint its range."""

    legs: np.ndarray          # (P,) leg of each point
    a: np.ndarray             # (P, 3)
    b: np.ndarray
    c: np.ndarray
    masses: np.ndarray        # (P,)
    q_hip: Tuple[int, ...]    # per leg
    q_ankle: Tuple[int, ...]
    ankle_axis: np.ndarray    # (legs, 3) unit axes
    contact_idx: Tuple[int, ...]
    contact_radii: Tuple[float, ...]
    q_lo: Tuple[float, ...]   # per joint, in q order
    q_hi: Tuple[float, ...]

    @property
    def n_joints(self) -> int:
        return len(self.q_lo)


def _point_table():
    """Per point (the JAX ``_points`` order): its leg, the constant vectors
    a, b, c of w = a + R_z·b + R_z·R_axis·c, and its mass."""
    legs, a, b, c, m = [], [], [], [], []

    def add(leg, av, bv=(0, 0, 0), cv=(0, 0, 0), mass=0.0):
        legs.append(leg)
        a.append(av)
        b.append(bv)
        c.append(cv)
        m.append(mass)

    add(0, (0, 0, 0), mass=0.4 * M_SPH)      # torso sphere: centre + 6 surface points
    for ax in range(3):
        for sign in (1.0, -1.0):
            e = np.zeros(3)
            e[ax] = sign * TORSO_R
            add(0, e, mass=M_SPH / 10.0)
    for leg in range(4):
        phi = math.radians(LEG_PHI[leg])
        u = np.array([math.cos(phi), math.sin(phi), 0.0])
        hip = L_LINK * u
        # fixed link capsule (torso body), upper leg, lower leg: ends + middle
        for frac, mass in ((0.0, M_LINK / 6), (0.5, 2 * M_LINK / 3), (1.0, M_LINK / 6)):
            add(leg, frac * hip, mass=mass)
        for frac, mass in ((0.0, M_UP / 6), (0.5, 2 * M_UP / 3), (1.0, M_UP / 6)):
            add(leg, hip, frac * L_UPPER * u, mass=mass)
        for frac, mass in ((0.0, M_LOW / 6), (0.5, 2 * M_LOW / 3), (1.0, M_LOW / 6)):
            add(leg, hip, L_UPPER * u, frac * L_LOWER * u, mass)
    return (np.array(legs), np.array(a), np.array(b), np.array(c), np.array(m))


def _coefficient_tables():
    """α = sin θ/θ, β = (1 − cos θ)/θ² and their first two derivatives in
    s = θ², as tables: closed forms Σ c·t·θ⁻ᵏ over t ∈ (sin θ, cos θ, 1 − cos θ)
    and k = 0…6, (3, 7, 6); Taylor series in powers s⁰…s³ for small θ, (4, 6)."""
    closed = np.zeros((3, 7, 6))
    SN, CS, OMC = 0, 1, 2
    closed[SN, 1, 0] = 1.0                                          # α
    closed[CS, 2, 1], closed[SN, 3, 1] = 0.5, -0.5                  # α′
    closed[SN, 3, 2], closed[CS, 4, 2], closed[SN, 5, 2] = -0.25, -0.75, 0.75   # α″
    closed[OMC, 2, 3] = 1.0                                         # β
    closed[SN, 3, 4], closed[OMC, 4, 4] = 0.5, -1.0                 # β′
    closed[CS, 4, 5], closed[SN, 5, 5], closed[OMC, 6, 5] = 0.25, -1.25, 2.0    # β″
    series = np.array([[1.0, -1 / 6, 1 / 60, 0.5, -1 / 24, 1 / 360],
                       [-1 / 6, 1 / 60, -1 / 840, -1 / 24, 1 / 360, -1 / 6720],
                       [1 / 120, -1 / 1680, 0.0, 1 / 720, -1 / 13440, 0.0],
                       [-1 / 5040, 0.0, 0.0, -1 / 40320, 0.0, 0.0]])
    return closed, series


class RotvecFrame:
    """The root's rotation R(r) = I + α(s)[r]ₓ + β(s)[r]ₓ² of a rotation
    vector r (s = r·r + 1e-12, θ = √s) and its derivatives, on ``device``.
    α, β and their first two derivatives in s are formed in float64 (series
    below θ = 1e-2, where the closed forms cancel) and rounded to float32;
    below θ = 1e-4 it is the JAX env's blend R = I + [r]ₓ."""

    def __init__(self, device: torch.device):
        closed, series = _coefficient_tables()
        self.closed = torch.as_tensor(closed, device=device)
        self.series = torch.as_tensor(series, device=device)
        self.powers = torch.arange(7, dtype=torch.float64, device=device)
        self.blend = torch.tensor([1.0, 0.0, 0.0, 0.0, 0.0, 0.0], device=device)
        self.e_skew = torch.as_tensor(np.stack([_skew(e) for e in np.eye(3)]).astype(np.float32),
                                      device=device)                # [eᵢ]ₓ
        self.eye = torch.eye(3, device=device)

    def coefficients(self, r: torch.Tensor) -> torch.Tensor:
        """(α, α′, α″, β, β′, β″) as (X, 6) float32 for r (X, 3)."""
        s = (r * r).sum(dim=1) + 1e-12
        s64 = s.double()
        theta = torch.sqrt(s64)
        trig = torch.stack([torch.sin(theta), torch.cos(theta),
                            2.0 * torch.sin(0.5 * theta) ** 2], dim=1)   # 1 − cos θ, no cancellation
        inv = theta[:, None] ** -self.powers
        closed = torch.einsum("xt,xk,tkj->xj", trig, inv, self.closed)
        series = (s64[:, None] ** self.powers[:4]) @ self.series
        coef = torch.where((theta < 1e-2)[:, None], series, closed).float()
        return torch.where((torch.sqrt(s) < 1e-4)[:, None], self.blend, coef)

    def _skews(self, r: torch.Tensor):
        outer = r[:, :, None] * r[:, None, :]
        kr = torch.einsum("iab,xi->xab", self.e_skew, r)             # [r]ₓ
        return kr, outer - (r * r).sum(dim=1)[:, None, None] * self.eye   # [r]ₓ²

    def rotation(self, r: torch.Tensor) -> torch.Tensor:
        """R(r) (X, 3, 3)."""
        al, _, _, be, _, _ = self.coefficients(r)[:, :, None, None].unbind(1)
        kr, kr2 = self._skews(r)
        return self.eye + al * kr + be * kr2

    def __call__(self, r: torch.Tensor, v: torch.Tensor):
        """R(r), ∂R/∂rᵢ (X, 3, 3, 3), and R̈ = D²R[v, v] along v; r, v (X, 3)."""
        al, al1, al2, be, be1, be2 = self.coefficients(r).unbind(1)
        col = lambda x: x[:, None, None]
        outer = lambda a, b: a[:, :, None] * b[:, None, :]
        eye = self.eye
        kr, kr2 = self._skews(r)
        R = eye + col(al) * kr + col(be) * kr2
        # ∂R/∂rᵢ = 2rᵢ(α′[r]ₓ + β′[r]ₓ²) + α[eᵢ]ₓ + β(r eᵢᵀ + eᵢ rᵀ − 2rᵢI), as (X, i, a, b)
        sym = (r[:, None, :, None] * eye[None, :, None, :] + eye[None, :, :, None]
               * r[:, None, None, :] - 2.0 * r[:, :, None, None] * eye)
        dR = (2.0 * r[:, :, None, None] * (col(al1) * kr + col(be1) * kr2)[:, None]
              + al[:, None, None, None] * self.e_skew + be[:, None, None, None] * sym)
        # D²R[v, v]: s along v changes by σ = 2r·v, with second derivative 2v·v
        sig = 2.0 * (r * v).sum(dim=1)
        sdd = 2.0 * (v * v).sum(dim=1)
        kv, kv2 = self._skews(v)
        cross = outer(r, v) + outer(v, r) - col(sig) * eye    # [v]ₓ[r]ₓ + [r]ₓ[v]ₓ
        Rdd = (col(al2 * sig * sig + al1 * sdd) * kr + col(2.0 * al1 * sig) * kv
               + col(be2 * sig * sig + be1 * sdd) * kr2 + col(2.0 * be1 * sig) * cross
               + col(2.0 * be) * kv2)
        return R, dR, Rdd


class AntState(NamedTuple):
    q: torch.Tensor    # (X, 14)
    qd: torch.Tensor   # (X, 14)
    t: torch.Tensor    # (X,) int32


def ant_body() -> LeggedBody:
    """The Ant's tables: 43 points, contacts on the torso and the 4 feet."""
    legs, a, b, c, m = _point_table()
    lo, hi = zip(*[ANKLE_RANGE[leg] if ank else HIP_RANGE for leg, ank in ACTUATORS])
    axes = np.stack([np.asarray(ANKLE_AXIS[leg]) / np.linalg.norm(ANKLE_AXIS[leg])
                     for leg in range(4)])
    return LeggedBody(legs, a, b, c, m, Q_HIP, Q_ANKLE, axes,
                      (0,) + tuple(7 + 9 * k + 8 for k in range(4)), (TORSO_R,) + (CAP_R,) * 4,
                      lo, hi)


class AntDynamics:
    """The batched physics of a legged body (the Ant's unless given) on
    ``device``."""

    def __init__(self, device: torch.device, body: LeggedBody = None):
        self.device = device
        body = ant_body() if body is None else body
        self.n_joints = n_joints = body.n_joints
        f = self._const
        legs, b, c = body.legs, body.b, body.c
        self.legs = torch.as_tensor(legs, device=device)
        self.pa, self.pb, self.pc, self.masses = f(body.a), f(b), f(c), f(body.masses)
        self.contact_idx = torch.as_tensor(body.contact_idx, device=device)
        self.contact_radii = f(body.contact_radii)
        self.q_hip = torch.as_tensor(body.q_hip, device=device)
        self.q_ankle = torch.as_tensor(body.q_ankle, device=device)
        self.q_lo, self.q_hi = f(body.q_lo), f(body.q_hi)
        # a point's hip and ankle columns of J (a point moves with its own
        # leg's joints, torso points with none)
        moves = (np.abs(b).sum(1) + np.abs(c).sum(1)) > 0
        hip_col = np.zeros((len(legs), n_joints))
        ank_col = np.zeros((len(legs), n_joints))
        for p, leg in enumerate(legs):
            hip_col[p, body.q_hip[leg] - 6] = moves[p]
            ank_col[p, body.q_ankle[leg] - 6] = moves[p]
        self.hip_col, self.ank_col = f(hip_col), f(ank_col)
        kz = _skew((0.0, 0.0, 1.0))
        ka = np.stack([_skew(axis) for axis in body.ankle_axis])
        self.kz, self.kz2 = f(kz), f(kz @ kz)
        self.ka, self.ka2 = f(ka), f(ka @ ka)
        self.root = RotvecFrame(device)
        self.eye3 = torch.eye(3, device=device)
        self.diag_m = f(np.concatenate([np.zeros(6), np.full(n_joints, ARMATURE)]) + 1e-8)

    def _const(self, x) -> torch.Tensor:
        """float64 numpy → float32, as the JAX package stores it."""
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    # --------------------------------------------------------- kinematics
    def kinematics(self, q: torch.Tensor, qd: torch.Tensor):
        """Point positions p (X, P, 3), J = ∂p/∂q (X, P, 3, dof) and
        a_bias = ∂(J q̇)/∂q · q̇ (X, P, 3) for q, q̇ (X, dof)."""
        X = q.shape[0]
        R, dR, Rdd = self.root(q[:, 3:6], qd[:, 3:6])
        Rd = fixed_sum(dR * qd[:, 3:6, None, None], 1)
        th, ta = q[:, self.q_hip], q[:, self.q_ankle]      # (X, legs)
        sh, ch, sa, ca = (x[..., None, None] for x in (torch.sin(th), torch.cos(th),
                                                         torch.sin(ta), torch.cos(ta)))
        rz = self.eye3 + sh * self.kz + (1.0 - ch) * self.kz2           # (X, legs, 3, 3)
        drz, ddrz = ch * self.kz + sh * self.kz2, -sh * self.kz + ch * self.kz2
        ra = self.eye3 + sa * self.ka + (1.0 - ca) * self.ka2
        dra, ddra = ca * self.ka + sa * self.ka2, -sa * self.ka + ca * self.ka2
        # per point, through its leg's rotations
        g = lambda m: m[:, self.legs]                                   # (X, P, 3, 3)
        mv = lambda m, v: fixed_sum(m * v[:, :, None], 3)
        c = self.pc.expand(X, -1, -1)
        b = self.pb.expand(X, -1, -1)
        ra_c, dra_c, ddra_c = mv(g(ra), c), mv(g(dra), c), mv(g(ddra), c)
        bc = b + ra_c                                                   # b + R_axis·c
        rz_p, drz_p, ddrz_p = g(rz), g(drz), g(ddrz)
        w = self.pa + mv(rz_p, bc)
        dw_h, dw_a = mv(drz_p, bc), mv(rz_p, dra_c)
        wh, wa = qd[:, self.q_hip][:, self.legs, None], qd[:, self.q_ankle][:, self.legs, None]
        wdot = wh * dw_h + wa * dw_a
        wddot = (wh * wh * mv(ddrz_p, bc) + 2.0 * wh * wa * mv(drz_p, dra_c)
                 + wa * wa * mv(rz_p, ddra_c))
        rot = lambda m, v: torch.einsum("xab,xpb->xpa", m, v)
        p = q[:, None, 0:3] + rot(R, w)
        j_rot = torch.einsum("xiab,xpb->xpai", dR, w)
        j_joint = (rot(R, dw_h)[..., None] * self.hip_col[:, None]
                   + rot(R, dw_a)[..., None] * self.ank_col[:, None])     # (X, P, 3, joints)
        J = torch.cat([self.eye3.expand(X, p.shape[1], 3, 3), j_rot, j_joint], dim=-1)
        a_bias = rot(Rdd, w) + 2.0 * rot(Rd, wdot) + rot(R, wddot)
        return p, J, a_bias

    def mass_matrix(self, J: torch.Tensor) -> torch.Tensor:
        """Σ mᵢ JᵢᵀJᵢ + diag(armature) + 1e-8·I (X, dof, dof), in J's dtype."""
        return (torch.einsum("p,xpci,xpcj->xij", self.masses.to(J.dtype), J, J)
                + torch.diag(self.diag_m.to(J.dtype)))

    def substep(self, q: torch.Tensor, qd: torch.Tensor, tau: torch.Tensor):
        """One implicit-damping Euler substep; returns (q′, q̇′, Σ normal
        forces) (ant.py:242-281). The kinematics are float32; the system
        (M + dt·D) q̇′ = M q̇ + dt·(Q − corio) is assembled and solved in
        float64 and q̇′ rounded once: its float32 sums and LU lose about ten
        times what XLA's float32 solve loses, and a free run then drifts from
        the JAX env twice as fast as the JAX env drifts from float64."""
        p, J, a_bias = self.kinematics(q, qd)
        Jc, cpos = J[:, self.contact_idx], p[:, self.contact_idx]
        v = fixed_sum(Jc * qd[:, None, None], 3)
        pen = torch.clamp(self.contact_radii - cpos[..., 2], min=0.0)
        N = CONTACT_K * pen
        vt = torch.sqrt(v[..., 0] ** 2 + v[..., 1] ** 2) + FRICTION_VREG
        ct = FRICTION_MU * N / vt
        qj = q[:, 6:]
        over = torch.clamp(qj - self.q_hi, min=0.0) - torch.clamp(self.q_lo - qj, min=0.0)
        outside = (over != 0.0).to(q.dtype)
        # float64 from here to the solve
        J, a_bias, Jc, m = J.double(), a_bias.double(), Jc.double(), self.masses.double()
        M = self.mass_matrix(J)
        X, dof = q.shape
        mJ = m[:, None, None] * J                                        # (X, P, 3, dof)
        corio = fixed_sum((mJ * a_bias[..., None]).reshape(X, -1, dof), 1)
        Q = -GRAVITY * fixed_sum(mJ[:, :, 2], 1)
        Q = torch.cat([Q[:, :6], Q[:, 6:] + GEAR * tau.double() - LIMIT_K * over.double()], dim=1)
        d_joint = JOINT_DAMPING + LIMIT_C * outside.double()
        D = torch.diag_embed(torch.cat([torch.zeros_like(d_joint[:, :6]), d_joint], dim=1))
        # ground contacts: penalty normal + implicit 2-D Coulomb friction
        Jz = Jc[:, :, 2]
        Q = Q + fixed_sum(N.double()[..., None] * Jz, 1)
        D = D + CONTACT_C * torch.einsum("xp,xpi,xpj->xij", (pen > 0.0).double(), Jz, Jz)
        D = D + torch.einsum("xp,xpci,xpcj->xij", ct.double(), Jc[:, :, :2], Jc[:, :, :2])
        rhs = fixed_sum(M * qd.double()[:, None], 2) + DT * (Q - corio)
        qd_new = torch.linalg.solve_ex(M + DT * D, rhs)[0].float()
        qd_new = torch.clamp(qd_new, -100.0, 100.0)
        return q + DT * qd_new, qd_new, N.sum(dim=1)

    def physics_step(self, q: torch.Tensor, qd: torch.Tensor, actions: torch.Tensor):
        """FRAME_SKIP substeps; returns (q, q̇, normal force averaged over them)."""
        tau = torch.clamp(actions, -1.0, 1.0)
        n_total = torch.zeros_like(q[:, 0])
        for _ in range(FRAME_SKIP):
            q, qd, n = self.substep(q, qd, tau)
            n_total = n_total + n
        return q, qd, n_total / FRAME_SKIP


class AntMAMuJoCo:
    """MAMuJoCo factorization of the 3D ant over a batch of envs:
    contiguous actuator partitions by ``agent_conf`` "NxM" (4x2: one leg an
    agent); per-agent obs = standardised concat(state, one-hot agent id);
    share_obs = state (26); team reward; truncation at ``episode_limit`` ⇒
    ``bad_transition``, unhealthy termination ⇒ ``dones`` alone."""

    def __init__(self, n_agents: int = 4, joints_per_agent: int = 2,
                 episode_limit: int = 1000, device: torch.device = torch.device("cpu")):
        self.n_agents = n_agents
        self.joints_per_agent = joints_per_agent
        self.episode_limit = episode_limit
        self.device = torch.device(device)
        self.dyn = AntDynamics(self.device)
        self.eye = torch.eye(n_agents, device=self.device)
        self.q0 = torch.zeros(DOF, device=self.device)
        self.q0[2] = QPOS0_Z

    @property
    def state_dim(self) -> int:
        return (DOF - 2) + DOF  # qpos[2:] (z + rotvec + joints) + qvel

    @property
    def obs_dim(self) -> int:
        return self.state_dim + self.n_agents

    @property
    def reset_noise_spec(self):
        """qpos's uniforms, then qvel's normals."""
        return (("uniform", DOF), ("normal", DOF))

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
        sizes[-1] += N_JOINTS - self.n_agents * self.joints_per_agent
        return sizes

    # ------------------------------------------------------------------ api
    def reset(self, noise: Tuple[torch.Tensor, torch.Tensor]) -> Tuple[AntState, TimeStep]:
        """``noise`` = (uniform [0, 1), standard normal), each (X, 14):
        q = (0, 0, 0.75, 0…) + U(−0.1, 0.1), q̇ = 0.1·N(0, 1) (ant.py:329-336)."""
        u, n = noise
        q = self.q0 + _uniform(u, RESET_NOISE)
        qd = RESET_NOISE * n
        X = q.shape[0]
        state = AntState(q=q, qd=qd, t=torch.zeros(X, dtype=torch.int32, device=self.device))
        no = torch.zeros(X, dtype=torch.bool, device=self.device)
        return state, self._timestep(state, torch.zeros(X, device=self.device), no, no)

    def step(self, state: AntState, actions: torch.Tensor) -> Tuple[AntState, TimeStep]:
        """actions (X, n_agents, max_act) in [-1, 1]; padding columns dropped
        (ant.py:338-356)."""
        sizes = self._agent_sizes()
        flat = torch.cat([actions[:, i, : sizes[i]] for i in range(self.n_agents)], dim=1)
        q, qd, contact_n = self.dyn.physics_step(state.q, state.qd, flat)
        vel_x = (q[:, 0] - state.q[:, 0]) / (DT * FRAME_SKIP)
        ctrl = CTRL_COST * (torch.clamp(flat, -1.0, 1.0) ** 2).sum(dim=1)
        healthy = self._is_healthy(q, qd)
        reward = (vel_x + HEALTHY_REWARD * healthy.to(q.dtype) - ctrl
                  - CONTACT_COST * contact_n ** 2)
        new_t = state.t + 1
        trunc = new_t >= self.episode_limit
        term = ~healthy
        new_state = AntState(q=q, qd=qd, t=new_t)
        return new_state, self._timestep(new_state, reward, term | trunc, trunc & ~term)

    def _is_healthy(self, q: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
        """(X,) bool: torso height in range, |rotation vector| below 1.9π,
        q and q̇ finite (ant.py:358-363)."""
        ok = (q[:, 2] > HEALTHY_Z[0]) & (q[:, 2] < HEALTHY_Z[1])
        ok = ok & (torch.linalg.vector_norm(q[:, 3:6], dim=1) < ROTVEC_MAX)
        return ok & torch.isfinite(q).all(dim=1) & torch.isfinite(qd).all(dim=1)

    # ---------------------------------------------------------- observation
    def _timestep(self, state: AntState, reward, done, bad) -> TimeStep:
        X, N = state.q.shape[0], self.n_agents
        sv = torch.cat([state.q[:, 2:], state.qd], dim=1)                   # (X, 26)
        obs = torch.cat([sv[:, None].expand(X, N, sv.shape[1]), self.eye.expand(X, N, N)],
                        dim=-1)
        # per-obs standardization with the population std (like jnp.std)
        mean = obs.mean(dim=-1, keepdim=True)
        std = obs.std(dim=-1, keepdim=True, correction=0) + 1e-8
        return TimeStep(
            obs=(obs - mean) / std,
            share_obs=sv,
            rewards=reward[:, None, None].expand(X, N, 1),
            dones=done[:, None].expand(X, N),
            bad_transition=bad,
        )


def make_ant(env_args: dict, device: torch.device) -> AntMAMuJoCo:
    conf = env_args.get("agent_conf", "4x2")
    n_agents, joints = (int(x) for x in conf.split("x"))
    if n_agents * joints > N_JOINTS:
        raise ValueError(f"agent_conf {conf} exceeds {N_JOINTS} joints")
    return AntMAMuJoCo(n_agents=n_agents, joints_per_agent=joints,
                       episode_limit=env_args.get("episode_limit", 1000), device=device)
