"""The many-agent swimmer for the port (counterpart of
``harl_tpu/envs/mamujoco_jax/swimmer.py``): MAMuJoCo's ``manyagent_swimmer``
(agent_conf "NxM": N agents of M joints, N·M + 1 links) and ``Swimmer-v2``,
stepped as a batch of X instances on one device.

The classic viscous swimmer (Coulom 2002): q = (x, y, θ₁…θ_L), absolute
link angles, link centres

    c_l = (x, y) + ℓ·Σ_{k<l} e(θ_k) + ℓ/2·e(θ_l),   e(θ) = (cos θ, sin θ)

so J = ∂c/∂q is (1, 0) and (0, 1) in x and y, and w_lk·ℓ·(−sin θ_k, cos θ_k)
in θ_k with w_lk = 1 for k < l, ½ for k = l; the bias acceleration along q̇
is −ℓ·Σ_k w_lk θ̇_k² e(θ_k). Where the JAX env takes J by ``jax.jacfwd``
and the bias by two nested ``jax.jvp``, the port writes both out. Each of 2
substeps of 0.025 s solves

    (M + dt·G) q̇′ = M q̇ + dt·(Bτ − m Σ_l J_lᵀ a_l),   q′ = q + dt·q̇′
    M = m Σ_l J_lᵀJ_l + diag(0, 0, I_link…) + 1e-6·I
    G = Σ_l k_t (t_l·J_l)ᵀ(t_l·J_l) + k_n (n_l·J_l)ᵀ(n_l·J_l)   (implicit drag)

with joint torque k acting +1 on link k+1 and −1 on link k, q̇′ clipped to
±100. The kinematics are float32; the (L+2)×(L+2) system is assembled and
solved in float64 and q̇′ rounded once (``substep``): the JAX env's own
float32 substep lands farther from its float64 substep than the port does
(``tests/test_torch_swimmer.py``). The sums over the links are
``fixed_sum``'s, so a row does not depend on the batch's width. Team
reward: forward velocity of the head's x minus 1e-4·Σ τ²; episodes end by
truncation only, so every done is a ``bad_transition``. Per-agent obs are standardized concat(state,
one-hot id) with the population std, share_obs = (θ, q̇).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from harl_tpu_torch.envs.core import TimeStep
from harl_tpu_torch.envs.mamujoco_jax.fixed_sum import fixed_sum
from harl_tpu_torch.envs.mamujoco_jax.planar import _uniform
from harl_tpu_torch.utils import spaces

DT = 0.05
LINK_LEN = 0.15
LINK_MASS = 1.0
DRAG_NORMAL = 25.0    # viscous drag ⟂ to the link
DRAG_TANGENT = 0.3    # viscous drag ∥ to the link
TORQUE_SCALE = 2.0
CTRL_COST = 1e-4
JOINT_LIMIT = 100.0   # rad/s velocity clamp
RESET_NOISE = 0.1


class SwimmerState(NamedTuple):
    q: torch.Tensor    # (X, L+2): x, y, θ₁…θ_L
    qd: torch.Tensor   # (X, L+2)
    t: torch.Tensor    # (X,) int32


class SwimmerDynamics:
    """The batched swimmer physics of ``n_links`` links on ``device``."""

    def __init__(self, n_links: int, device: torch.device):
        self.L = L = n_links
        self.device = device
        w = np.tril(np.ones((L, L)), -1) + 0.5 * np.eye(L)             # w_lk
        self.w = torch.as_tensor(w.astype(np.float32), device=device)
        # joint k pushes link k+1 and pulls link k: τ_links = B·τ_joints
        B = np.zeros((L, L - 1))
        B[1:] += np.eye(L - 1)
        B[:-1] -= np.eye(L - 1)
        self.B = torch.as_tensor(B, device=device)                        # float64
        inertia = np.zeros(L + 2)
        inertia[2:] = np.float32(LINK_MASS * LINK_LEN ** 2 / 12.0)
        self.diag_m = torch.as_tensor(inertia.astype(np.float32) + np.float32(1e-6),
                                      device=device).double()

    def kinematics(self, q: torch.Tensor, qd: torch.Tensor):
        """J = ∂c/∂q (X, L, 2, L+2) and the bias acceleration (X, L, 2)."""
        X, L = q.shape[0], self.L
        th = q[:, 2:]
        s, c = torch.sin(th), torch.cos(th)
        J = q.new_zeros((X, L, 2, L + 2))
        J[:, :, 0, 0] = 1.0
        J[:, :, 1, 1] = 1.0
        J[:, :, 0, 2:] = -(self.w * (LINK_LEN * s)[:, None, :])
        J[:, :, 1, 2:] = self.w * (LINK_LEN * c)[:, None, :]
        w2 = qd[:, 2:] ** 2
        bias = -LINK_LEN * torch.stack([fixed_sum((w2 * c)[:, None] * self.w, 2),
                                        fixed_sum((w2 * s)[:, None] * self.w, 2)], dim=-1)
        return J, bias, torch.stack([c, s], dim=-1)

    def substep(self, q: torch.Tensor, qd: torch.Tensor, torques: torch.Tensor, dt: float):
        """One implicit-drag Euler substep (swimmer.py:97-143)."""
        J, bias, tang = self.kinematics(q, qd)
        J, bias, tang = J.double(), bias.double(), tang.double()
        norm = torch.stack([-tang[..., 1], tang[..., 0]], dim=-1)
        Jt = torch.einsum("xlc,xlcj->xlj", tang, J)
        Jn = torch.einsum("xlc,xlcj->xlj", norm, J)
        G = (DRAG_TANGENT * fixed_sum(Jt[..., None] * Jt[:, :, None], 1)
             + DRAG_NORMAL * fixed_sum(Jn[..., None] * Jn[:, :, None], 1))
        M = LINK_MASS * torch.einsum("xlci,xlcj->xij", J, J) + torch.diag(self.diag_m)
        corio = LINK_MASS * fixed_sum((J * bias[..., None]).flatten(1, 2), 1)
        tau = torques.double() @ self.B.T
        Q = torch.cat([torch.zeros_like(tau[:, :2]), tau], dim=1)
        rhs = fixed_sum(M * qd.double()[:, None], 2) + dt * (Q - corio)
        qd_new = torch.linalg.solve_ex(M + dt * G, rhs)[0].float()
        qd_new = torch.clamp(qd_new, -JOINT_LIMIT, JOINT_LIMIT)
        return q + dt * qd_new, qd_new


class ManyAgentSwimmer:
    """The swimmer's MAMuJoCo partition over a batch of envs: agent i
    drives joints i·M … i·M + M − 1."""

    def __init__(self, n_agents: int = 4, joints_per_agent: int = 2,
                 episode_limit: int = 1000, device: torch.device = torch.device("cpu")):
        self.n_agents, self.joints_per_agent = n_agents, joints_per_agent
        self.episode_limit = episode_limit
        self.device = torch.device(device)
        self.dyn = SwimmerDynamics(self.n_links, self.device)
        self.eye = torch.eye(n_agents, device=self.device)

    @property
    def n_links(self) -> int:
        return self.n_agents * self.joints_per_agent + 1

    @property
    def state_dim(self) -> int:
        return self.n_links + (self.n_links + 2)   # θ (no x, y) and every velocity

    @property
    def obs_dim(self) -> int:
        return self.state_dim + self.n_agents

    @property
    def reset_noise_spec(self):
        """The link angles' uniforms, then the velocities'."""
        return (("uniform", self.n_links), ("uniform", self.n_links + 2))

    @property
    def observation_space(self):
        return [spaces.Box.create(-np.inf, np.inf, self.obs_dim)] * self.n_agents

    @property
    def share_observation_space(self):
        return [spaces.Box.create(-np.inf, np.inf, self.state_dim)] * self.n_agents

    @property
    def action_space(self):
        return [spaces.Box.create(-1.0, 1.0, self.joints_per_agent)] * self.n_agents

    # ------------------------------------------------------------------ api
    def reset(self, noise) -> Tuple[SwimmerState, TimeStep]:
        """θ ~ U(−0.1, 0.1) at the origin, q̇ ~ U(−0.1, 0.1) (swimmer.py:145-154)."""
        u_th, u_qd = noise
        X = u_th.shape[0]
        q = torch.cat([torch.zeros((X, 2), device=self.device), _uniform(u_th, RESET_NOISE)],
                      dim=1)
        state = SwimmerState(q=q, qd=_uniform(u_qd, RESET_NOISE),
                             t=torch.zeros(X, dtype=torch.int32, device=self.device))
        no = torch.zeros(X, dtype=torch.bool, device=self.device)
        return state, self._timestep(state, torch.zeros(X, device=self.device), no)

    def step(self, state: SwimmerState, actions: torch.Tensor):
        """actions (X, N, M) in [−1, 1] (swimmer.py:156-168)."""
        X = actions.shape[0]
        torques = torch.clamp(actions.reshape(X, -1), -1.0, 1.0) * TORQUE_SCALE
        q, qd = state.q, state.qd
        for _ in range(2):
            q, qd = self.dyn.substep(q, qd, torques, DT / 2)
        com_vx = (q[:, 0] - state.q[:, 0]) / DT
        reward = com_vx - CTRL_COST * (torques ** 2).sum(dim=1)
        new_t = state.t + 1
        new_state = SwimmerState(q=q, qd=qd, t=new_t)
        return new_state, self._timestep(new_state, reward, new_t >= self.episode_limit)

    # ---------------------------------------------------------- observation
    def _timestep(self, state: SwimmerState, reward, done) -> TimeStep:
        X, N = state.q.shape[0], self.n_agents
        sv = torch.cat([state.q[:, 2:], state.qd], dim=1)
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


def make_swimmer(env_args: dict, device: torch.device) -> ManyAgentSwimmer:
    """``agent_conf`` "NxM" (default 4x2), for ``manyagent_swimmer`` and
    ``Swimmer-v2`` alike (swimmer.py:193-200)."""
    n_agents, joints = (int(x) for x in env_args.get("agent_conf", "4x2").split("x"))
    return ManyAgentSwimmer(n_agents=n_agents, joints_per_agent=joints,
                            episode_limit=env_args.get("episode_limit", 1000), device=device)
