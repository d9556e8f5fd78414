"""coupled_half_cheetah for the port (counterpart of
``harl_tpu/envs/mamujoco_jax/coupled.py``): two planar HalfCheetahs joined
by a tendon between their torsos, one agent a cheetah (agent_conf "1p1"),
stepped as a batch of X instances on one device.

Each cheetah is the port's planar HalfCheetah (``planar.py``). The tendon
is an in-plane force on the roots, recomputed every substep from the
cheetahs' positions before it: with the torsos a constant 2.0 apart out of
the plane, its length is ℓ = √(Δx² + Δz² + 4) and its tension
0.1·(ℓ − 2) plus a 2000 N/m penalty beyond the range [1.5, 3.5]; cheetah A
gets −tension·Δ/ℓ, B the opposite. Both cheetahs of a substep step from
the old state, as one batch of 2X. Team reward: the mean of the two run
rewards minus the mean of the two control costs (0.1·Σ τ²); no unhealthy
termination, so every done is a truncation. Observations keep the
reference's quirk: concat(qpos[1:], qvel) over the stacked 18-dof vector,
so the second cheetah's absolute x stays in the state.

``reset`` takes the cheetahs' qpos uniforms and qvel normals, each (X, 18)
for the (2, 9) coordinates (``reset_noise_spec``).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from harl_tpu_torch.envs.core import TimeStep
from harl_tpu_torch.envs.mamujoco_jax.planar import HALF_CHEETAH, PlanarDynamics, _uniform
from harl_tpu_torch.utils import spaces

TENDON_Y_SEP = 2.0          # constant |Δy| between the two torsos
TENDON_REST = 2.0           # tendon length at qpos0
TENDON_STIFF = 0.1          # xml: stiffness="0.1"
TENDON_LIMITS = (1.5, 3.5)  # xml: range="1.5 3.5" (a hard limit → a penalty)
LIMIT_STIFF = 2000.0


class CoupledState(NamedTuple):
    q: torch.Tensor   # (X, 2, 9) per-cheetah generalized coordinates
    qd: torch.Tensor  # (X, 2, 9)
    t: torch.Tensor   # (X,) int32


class CoupledHalfCheetah:
    """Two agents, one whole cheetah each."""

    n_agents = 2

    def __init__(self, episode_limit: int = 1000, device: torch.device = torch.device("cpu")):
        self.episode_limit = episode_limit
        self.device = torch.device(device)
        self.dyn = PlanarDynamics(HALF_CHEETAH, self.device)
        self.eye = torch.eye(2, device=self.device)

    @property
    def spec(self):
        return self.dyn.spec

    @property
    def state_dim(self) -> int:
        return 2 * self.spec.dof * 2 - 1       # qpos[1:] (17) + qvel (18)

    @property
    def obs_dim(self) -> int:
        return self.state_dim + self.n_agents

    @property
    def reset_noise_spec(self):
        dof2 = 2 * self.spec.dof
        return (("uniform", dof2), ("normal", dof2))

    @property
    def observation_space(self):
        return [spaces.Box.create(-np.inf, np.inf, self.obs_dim)] * 2

    @property
    def share_observation_space(self):
        return [spaces.Box.create(-np.inf, np.inf, self.state_dim)] * 2

    @property
    def action_space(self):
        return [spaces.Box.create(-1.0, 1.0, self.spec.n_joints)] * 2

    # ------------------------------------------------------------------ api
    def reset(self, noise) -> Tuple[CoupledState, TimeStep]:
        """q ~ U(−0.1, 0.1), q̇ = 0.1·N(0, 1) per cheetah (coupled.py:87-94)."""
        u, n = noise
        X, dof = u.shape[0], self.spec.dof
        state = CoupledState(q=_uniform(u, 0.1).reshape(X, 2, dof),
                             qd=(0.1 * n).reshape(X, 2, dof),
                             t=torch.zeros(X, dtype=torch.int32, device=self.device))
        no = torch.zeros(X, dtype=torch.bool, device=self.device)
        return state, self._timestep(state, torch.zeros(X, device=self.device), no)

    def tendon_force(self, qA: torch.Tensor, qB: torch.Tensor) -> torch.Tensor:
        """The in-plane force (X, 2) on cheetah A's root; B gets its negative
        (coupled.py:96-107)."""
        d = qA[:, :2] - qB[:, :2]
        length = torch.sqrt((d * d).sum(dim=1) + TENDON_Y_SEP ** 2)
        tension = TENDON_STIFF * (length - TENDON_REST)
        tension = tension + LIMIT_STIFF * torch.clamp(length - TENDON_LIMITS[1], min=0.0)
        # the lower limit cannot bind (ℓ ≥ 2 > 1.5); kept as the XML states it
        tension = tension - LIMIT_STIFF * torch.clamp(TENDON_LIMITS[0] - length, min=0.0)
        return -tension[:, None] * d / length[:, None]

    def step(self, state: CoupledState, actions: torch.Tensor):
        """actions (X, 2, 6) in [−1, 1] (coupled.py:109-130)."""
        spec, X = self.spec, state.q.shape[0]
        tau = torch.clamp(actions.reshape(X, 2, spec.n_joints), -1.0, 1.0)
        tau2 = torch.cat([tau[:, 0], tau[:, 1]])
        q2 = torch.cat([state.q[:, 0], state.q[:, 1]])      # (2X, 9): A rows, then B
        qd2 = torch.cat([state.qd[:, 0], state.qd[:, 1]])
        for _ in range(spec.frame_skip):
            f = self.tendon_force(q2[:X], q2[X:])
            q2, qd2 = self.dyn.substep(q2, qd2, tau2, root_force=torch.cat([f, -f]))
        q, qd = torch.stack([q2[:X], q2[X:]], dim=1), torch.stack([qd2[:X], qd2[X:]], dim=1)
        dt_env = spec.dt * spec.frame_skip
        run = ((q[:, 0, 0] - state.q[:, 0, 0]) + (q[:, 1, 0] - state.q[:, 1, 0])) / dt_env / 2.0
        ctrl = 0.1 * ((tau[:, 0] ** 2).sum(dim=1) + (tau[:, 1] ** 2).sum(dim=1)) / 2.0
        new_t = state.t + 1
        new_state = CoupledState(q=q, qd=qd, t=new_t)
        return new_state, self._timestep(new_state, run - ctrl, new_t >= self.episode_limit)

    # ---------------------------------------------------------- observation
    def _timestep(self, state: CoupledState, reward, done) -> TimeStep:
        X = state.q.shape[0]
        sv = torch.cat([state.q.reshape(X, -1)[:, 1:], state.qd.reshape(X, -1)], dim=1)
        obs = torch.cat([sv[:, None].expand(X, 2, sv.shape[1]), self.eye.expand(X, 2, 2)],
                        dim=-1)
        mean = obs.mean(dim=-1, keepdim=True)
        std = obs.std(dim=-1, keepdim=True, correction=0) + 1e-8
        return TimeStep(
            obs=(obs - mean) / std,
            share_obs=sv,
            rewards=reward[:, None, None].expand(X, 2, 1),
            dones=done[:, None].expand(X, 2),
            bad_transition=done,     # never terminates: every done is a truncation
        )


def make_coupled(env_args: dict, device: torch.device) -> CoupledHalfCheetah:
    conf = env_args.get("agent_conf", "1p1")
    if conf not in ("1p1", None):
        raise ValueError(f"coupled_half_cheetah supports agent_conf '1p1', got {conf!r}")
    return CoupledHalfCheetah(episode_limit=env_args.get("episode_limit", 1000), device=device)
