"""Reacher-v2 for the port (counterpart of ``harl_tpu/envs/mamujoco_jax/reacher.py``):
MAMuJoCo's 2x1 reacher, one agent a joint of Gym's 2-link planar arm,
stepped as a batch of X instances on one device.

Two 0.1 m links turn about z in the horizontal plane (no gravity torque);
each joint has armature 1 and damping 1, gear 200; joint 1 is limited to
±3 rad by a penalty spring and damper; 2 substeps of 0.01 s an env step.
The arm is five point masses p = a·e(θ₀) + b·e(θ₀ + θ₁), e(φ) = (cos φ, sin φ),
at (a, b) = (ℓ/2, 0), (ℓ, 0), (ℓ, ℓ/2), (ℓ, ℓ) and the fingertip (ℓ, 0.11), so

    J = [a e⊥(θ₀) + b e⊥(θ₀+θ₁),  b e⊥(θ₀+θ₁)],   e⊥(φ) = (−sin φ, cos φ)
    a_bias = −a θ̇₀² e(θ₀) − b (θ̇₀ + θ̇₁)² e(θ₀+θ₁)

written out where the JAX env takes ``jax.jacfwd`` and nested ``jax.jvp``.
The 2×2 system (M + dt·diag(damping)) q̇′ = M q̇ + dt·(Q − Σ m Jᵀ a_bias) is
assembled and solved in float64 and q̇′ rounded once, the bias force summed
by ``fixed_sum`` (a batched matmul would round it by the batch's width on
the card). Reward (Gym reacher.py): −‖fingertip − target‖, the fingertip
read BEFORE the physics step, minus ‖a‖²; episodes end only by truncation
at ``episode_limit`` (50).

``reset`` takes four uniform draws on [0, 1) (``reset_noise_spec``): q ±0.1,
q̇ ±0.005, and the target 0.2·√u at the angle φ = u·2π in the disk.
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

DT = 0.01
FRAME_SKIP = 2
GEAR = 200.0
ARMATURE = 1.0
JOINT_DAMPING = 1.0
LINK_LEN = 0.1
FINGER_LEN = 0.11          # elbow → fingertip
LINK_MASS = 1000.0 * (math.pi * 0.01 ** 2 * LINK_LEN + (4.0 / 3.0) * math.pi * 0.01 ** 3)
J1_RANGE = (-3.0, 3.0)
LIMIT_K = 300.0
LIMIT_C = 10.0
EPISODE_LIMIT = 50

# per point: the coefficients (a, b) of e(θ₀) and e(θ₀ + θ₁), and its mass
_PT_A = (0.5 * LINK_LEN, LINK_LEN, LINK_LEN, LINK_LEN, LINK_LEN)
_PT_B = (0.0, 0.0, 0.5 * LINK_LEN, LINK_LEN, FINGER_LEN)
_PT_MASS = (2 * LINK_MASS / 3, LINK_MASS / 3, 2 * LINK_MASS / 3, LINK_MASS / 3, 0.01)


class ReacherState(NamedTuple):
    q: torch.Tensor       # (X, 2) joint angles
    qd: torch.Tensor      # (X, 2)
    target: torch.Tensor  # (X, 2)
    t: torch.Tensor       # (X,) int32


def _e(phi: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.cos(phi), torch.sin(phi)], dim=-1)


class ReacherMAMuJoCo:
    """MAMuJoCo Reacher-v2 2x1 over a batch of envs."""

    n_agents = 2

    def __init__(self, episode_limit: int = EPISODE_LIMIT,
                 device: torch.device = torch.device("cpu")):
        self.episode_limit = episode_limit
        self.device = torch.device(device)
        f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        self.pa, self.pb, self.pm = f(_PT_A), f(_PT_B), f(_PT_MASS)
        self.eye = torch.eye(2, device=self.device)

    @property
    def state_dim(self) -> int:
        return 4 + 2 + 2 + 2   # cos/sin of both joints, target, q̇, fingertip − target

    @property
    def obs_dim(self) -> int:
        return self.state_dim + self.n_agents

    @property
    def reset_noise_spec(self):
        return (("uniform", 2), ("uniform", 2), ("uniform", 1), ("uniform", 1))

    @property
    def observation_space(self):
        return [spaces.Box.create(-np.inf, np.inf, self.obs_dim)] * self.n_agents

    @property
    def share_observation_space(self):
        return [spaces.Box.create(-np.inf, np.inf, self.state_dim)] * self.n_agents

    @property
    def action_space(self):
        return [spaces.Box.create(-1.0, 1.0, 1)] * self.n_agents

    # ------------------------------------------------------------ physics
    def points(self, q: torch.Tensor) -> torch.Tensor:
        """The five points (X, 5, 2), the fingertip last."""
        e0, e1 = _e(q[:, 0]), _e(q[:, 0] + q[:, 1])
        return self.pa[:, None] * e0[:, None] + self.pb[:, None] * e1[:, None]

    def kinematics(self, q: torch.Tensor, qd: torch.Tensor):
        """J (X, 5, 2, 2) and the bias acceleration (X, 5, 2)."""
        th1 = q[:, 0] + q[:, 1]
        e0, e1 = _e(q[:, 0]), _e(th1)
        perp = lambda e: torch.stack([-e[:, 1], e[:, 0]], dim=-1)[:, None]
        a, b = self.pa[:, None], self.pb[:, None]
        j1 = b * perp(e1)
        J = torch.stack([a * perp(e0) + j1, j1], dim=-1)
        w0, w01 = qd[:, 0], qd[:, 0] + qd[:, 1]
        bias = -(a * (w0 * w0)[:, None, None] * e0[:, None]
                 + b * (w01 * w01)[:, None, None] * e1[:, None])
        return J, bias

    def substep(self, q: torch.Tensor, qd: torch.Tensor, tau: torch.Tensor):
        """One implicit-damping Euler substep (reacher.py:121-137)."""
        J, bias = self.kinematics(q, qd)
        J, bias, m = J.double(), bias.double(), self.pm.double()
        M = torch.einsum("p,xpci,xpcj->xij", m, J, J) + ARMATURE * self.eye.double()
        corio = fixed_sum((m[:, None, None] * J * bias[..., None]).flatten(1, 2), 1)
        over = (torch.clamp(q[:, 1] - J1_RANGE[1], min=0.0)
                - torch.clamp(J1_RANGE[0] - q[:, 1], min=0.0))
        Q = GEAR * tau.double()
        Q = torch.stack([Q[:, 0], Q[:, 1] - LIMIT_K * over.double()], dim=1)
        damp = torch.stack([torch.full_like(over, JOINT_DAMPING),
                            JOINT_DAMPING + LIMIT_C * (over != 0.0).to(q.dtype)], dim=1)
        rhs = torch.einsum("xij,xj->xi", M, qd.double()) + DT * (Q - corio)
        qd_new = torch.linalg.solve_ex(M + DT * torch.diag_embed(damp.double()), rhs)[0].float()
        return q + DT * qd_new, qd_new

    # ------------------------------------------------------------------ api
    def reset(self, noise) -> Tuple[ReacherState, TimeStep]:
        """(reacher.py:107-119)"""
        uq, uqd, ur, uphi = noise
        X = uq.shape[0]
        r = 0.2 * torch.sqrt(ur[:, 0])
        phi = torch.clamp(uphi[:, 0] * float(np.float32(2.0 * math.pi)), min=0.0)
        state = ReacherState(q=_uniform(uq, 0.1), qd=_uniform(uqd, 0.005),
                             target=r[:, None] * _e(phi),
                             t=torch.zeros(X, dtype=torch.int32, device=self.device))
        no = torch.zeros(X, dtype=torch.bool, device=self.device)
        return state, self._timestep(state, torch.zeros(X, device=self.device), no)

    def step(self, state: ReacherState, actions: torch.Tensor):
        """actions (X, 2, 1) in [−1, 1] (reacher.py:139-154)."""
        a = torch.clamp(actions.reshape(actions.shape[0], 2), -1.0, 1.0)
        diff = self.points(state.q)[:, -1] - state.target
        dist = torch.sqrt((diff * diff).sum(dim=1))
        q, qd = state.q, state.qd
        for _ in range(FRAME_SKIP):
            q, qd = self.substep(q, qd, a)
        reward = -dist - (a * a).sum(dim=1)
        new_t = state.t + 1
        new_state = ReacherState(q=q, qd=qd, target=state.target, t=new_t)
        return new_state, self._timestep(new_state, reward, new_t >= self.episode_limit)

    # ---------------------------------------------------------- observation
    def _timestep(self, state: ReacherState, reward, done) -> TimeStep:
        X, N = state.q.shape[0], self.n_agents
        tip = self.points(state.q)[:, -1]
        sv = torch.cat([torch.cos(state.q), torch.sin(state.q), state.target, state.qd,
                        tip - state.target], dim=1)
        obs = torch.cat([sv[:, None].expand(X, N, sv.shape[1]), self.eye.expand(X, N, N)],
                        dim=-1)
        mean = obs.mean(dim=-1, keepdim=True)
        std = obs.std(dim=-1, keepdim=True, correction=0) + 1e-8
        return TimeStep(
            obs=(obs - mean) / std,
            share_obs=sv,
            rewards=reward[:, None, None].expand(X, N, 1),
            dones=done[:, None].expand(X, N),
            bad_transition=done,     # truncation-only episodes
        )


def make_reacher(env_args: dict, device: torch.device) -> ReacherMAMuJoCo:
    if int(env_args.get("agent_conf", "2x1").split("x")[0]) != 2:
        raise ValueError("Reacher-v2 supports agent_conf 2x1 only")
    return ReacherMAMuJoCo(episode_limit=env_args.get("episode_limit", EPISODE_LIMIT),
                           device=device)
