"""The many-agent ant for the port (counterpart of
``harl_tpu/envs/mamujoco_jax/manyagent_ant.py``): MAMuJoCo's custom
N-segment ant (agent_conf "NxM": N agents of M segments, 4 actuators a
segment), stepped as a batch of X instances on one device.

The generated model is a rigid chain of torso capsules (length 1, radius
0.1, density 100; segment 0 carries its legs only), each segment with two
diagonal legs of a z hip (±30°) and an ankle about a diagonal axis
((30°, 70°) on segment 0, (−70°, −30°) on the trailing segments, whose legs
point backwards); gear 150 in the order hip, ankle of the left leg, then of
the right one, per segment. It is the Ant's tree with more legs and a
longer torso, so it runs on the port's Ant machinery (``ant.py``): the
point tables of a ``LeggedBody`` (torso capsules as three points at m/6,
2m/3, m/6; each leg's aux, upper and lower capsules likewise), the root's
``RotvecFrame``, the written-out J and bias acceleration, and the system
assembled and solved in float64 (``AntDynamics``). Contacts are the chain
nodes (radius 0.1) and the feet (0.08). Reward: the root's forward
velocity + 1 while healthy − 0.5·Σ a² − 5e-4·(mean normal force)²;
unhealthy (a termination) when the root's z leaves (0.2, 1.0), its
rotation vector reaches 1.9π or the state is not finite.

``reset`` takes qpos's uniforms and qvel's normals (``reset_noise_spec``):
q = (0, 0, 0.55, 0, 0, 0, mid-range joints) + U(−0.1, 0.1), q̇ = 0.1·N(0, 1).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from harl_tpu_torch.envs.core import TimeStep
from harl_tpu_torch.envs.mamujoco_jax.ant import (CONTACT_COST, CTRL_COST, HEALTHY_REWARD,
                                                  HEALTHY_Z, ROTVEC_MAX, AntDynamics,
                                                  LeggedBody)
from harl_tpu_torch.envs.mamujoco_jax.planar import _uniform
from harl_tpu_torch.utils import spaces

DT = 0.01
FRAME_SKIP = 5
TORSO_DENSITY = 100.0
TORSO_R = 0.1
TORSO_LEN = 1.0
LEG_R = 0.08
L_AUX = 0.2 * math.sqrt(2.0)     # segment 0's aux |(0.2, 0.2, 0)|; trailing aux 0.2
L_UPPER = 0.2 * math.sqrt(2.0)
L_LOWER = 0.4 * math.sqrt(2.0)
QPOS0_Z = 0.55
RESET_NOISE = 0.1

HIP_RANGE = (-math.radians(30.0), math.radians(30.0))
ANKLE_RANGE_FRONT = (math.radians(30.0), math.radians(70.0))
ANKLE_RANGE_BACK = (-math.radians(70.0), -math.radians(30.0))


def _capsule_mass(rho: float, r: float, length: float) -> float:
    return rho * (math.pi * r * r * length + (4.0 / 3.0) * math.pi * r ** 3)


def _leg_table(n_segs: int):
    """Per leg, in q order (segment by segment, left leg then right):
    attach point, aux vector, leg direction u, ankle axis, ankle range and
    aux length (manyagent_ant.py:71-101)."""
    legs = []
    for si in range(n_segs):
        for s in (1.0, -1.0):
            if si == 0:
                u = (1.0 / math.sqrt(2.0), s / math.sqrt(2.0), 0.0)
                aux = (0.2, s * 0.2, 0.0)
                axis = (-1.0, 1.0, 0.0) if s > 0 else (1.0, 1.0, 0.0)
                rng, aux_len = ANKLE_RANGE_FRONT, L_AUX
            else:
                u = (-1.0 / math.sqrt(2.0), s / math.sqrt(2.0), 0.0)
                aux = (0.0, s * 0.2, 0.0)
                axis = (1.0, 1.0, 0.0) if s > 0 else (-1.0, 1.0, 0.0)
                rng, aux_len = ANKLE_RANGE_BACK, 0.2
            legs.append(dict(attach=(-float(si), 0.0, 0.0), aux=aux, u=u, axis=axis,
                             range=rng, aux_len=aux_len))
    return legs


def manyant_body(n_segs: int) -> LeggedBody:
    """The point tables in the JAX ``_points`` order: the trailing torso
    capsules, then per leg its aux, upper and lower capsules; the contacts
    (chain node 0 is leg 0's attach point, node k segment k's torso end)."""
    legs, a, b, c, m = [], [], [], [], []

    def add(leg, av, bv=(0, 0, 0), cv=(0, 0, 0), mass=0.0):
        legs.append(leg)
        a.append(av)
        b.append(bv)
        c.append(cv)
        m.append(mass)

    mt = _capsule_mass(TORSO_DENSITY, TORSO_R, TORSO_LEN)
    node = [None] * n_segs
    for si in range(1, n_segs):
        p0, p1 = np.array([-(si - 1.0), 0, 0]), np.array([-float(si), 0, 0])
        for pos, mass in ((p0, mt / 6), (0.5 * (p0 + p1), 2 * mt / 3), (p1, mt / 6)):
            add(0, pos, mass=mass)
        node[si] = len(a) - 1
    m_up, m_low = (_capsule_mass(5.0, LEG_R, x) for x in (L_UPPER, L_LOWER))
    feet = []
    table = _leg_table(n_segs)
    for li, leg in enumerate(table):
        attach, aux, u = (np.asarray(leg[k]) for k in ("attach", "aux", "u"))
        hip = attach + aux
        m_aux = _capsule_mass(5.0, LEG_R, leg["aux_len"])
        if li == 0:
            node[0] = len(a)
        for pos, mass in ((attach, m_aux / 6), (0.5 * (attach + hip), 2 * m_aux / 3),
                          (hip, m_aux / 6)):
            add(li, pos, mass=mass)
        for frac, mass in ((0.0, m_up / 6), (0.5, 2 * m_up / 3), (1.0, m_up / 6)):
            add(li, hip, frac * L_UPPER * u, mass=mass)
        for frac, mass in ((0.0, m_low / 6), (0.5, 2 * m_low / 3), (1.0, m_low / 6)):
            add(li, hip, L_UPPER * u, frac * L_LOWER * u, mass)
        feet.append(len(a) - 1)
    axes = np.stack([np.asarray(leg["axis"]) / np.linalg.norm(leg["axis"]) for leg in table])
    lo = [x for leg in table for x in (HIP_RANGE[0], leg["range"][0])]
    hi = [x for leg in table for x in (HIP_RANGE[1], leg["range"][1])]
    n_legs = len(table)
    return LeggedBody(np.array(legs), np.array(a, np.float64), np.array(b, np.float64),
                      np.array(c, np.float64), np.array(m),
                      tuple(6 + 2 * k for k in range(n_legs)),
                      tuple(7 + 2 * k for k in range(n_legs)), axes,
                      tuple(node) + tuple(feet), (TORSO_R,) * n_segs + (LEG_R,) * n_legs,
                      tuple(lo), tuple(hi))


class ManyAntState(NamedTuple):
    q: torch.Tensor    # (X, 6 + 4·n_segs)
    qd: torch.Tensor
    t: torch.Tensor    # (X,) int32


class ManyAgentAnt:
    """The MAMuJoCo partition of the N-segment ant over a batch of envs:
    agent i drives segments i·M … i·M + M − 1 (4 actuators each)."""

    def __init__(self, n_agents: int = 2, segs_per_agent: int = 3, episode_limit: int = 1000,
                 device: torch.device = torch.device("cpu")):
        self.n_agents, self.segs_per_agent = n_agents, segs_per_agent
        self.episode_limit = episode_limit
        self.device = torch.device(device)
        self.n_segs = n_agents * segs_per_agent
        body = manyant_body(self.n_segs)
        self.dyn = AntDynamics(self.device, body)
        mid = 0.5 * (np.asarray(body.q_lo) + np.asarray(body.q_hi))
        self.q0 = torch.as_tensor(np.concatenate([[0.0, 0.0, QPOS0_Z, 0.0, 0.0, 0.0],
                                                  mid]).astype(np.float32), device=self.device)
        self.eye = torch.eye(n_agents, device=self.device)

    @property
    def dof(self) -> int:
        return 6 + 4 * self.n_segs

    @property
    def act_per_agent(self) -> int:
        return 4 * self.segs_per_agent

    @property
    def state_dim(self) -> int:
        return (self.dof - 2) + self.dof    # qpos[2:] + qvel

    @property
    def obs_dim(self) -> int:
        return self.state_dim + self.n_agents

    @property
    def reset_noise_spec(self):
        return (("uniform", self.dof), ("normal", self.dof))

    @property
    def observation_space(self):
        return [spaces.Box.create(-np.inf, np.inf, self.obs_dim)] * self.n_agents

    @property
    def share_observation_space(self):
        return [spaces.Box.create(-np.inf, np.inf, self.state_dim)] * self.n_agents

    @property
    def action_space(self):
        return [spaces.Box.create(-1.0, 1.0, self.act_per_agent)] * self.n_agents

    # ------------------------------------------------------------------ api
    def physics_step(self, q: torch.Tensor, qd: torch.Tensor, actions: torch.Tensor):
        """FRAME_SKIP substeps; returns (q, q̇, normal force averaged over them)."""
        tau = torch.clamp(actions, -1.0, 1.0)
        n_total = torch.zeros_like(q[:, 0])
        for _ in range(FRAME_SKIP):
            q, qd, n = self.dyn.substep(q, qd, tau)
            n_total = n_total + n
        return q, qd, n_total / FRAME_SKIP

    def reset(self, noise) -> Tuple[ManyAntState, TimeStep]:
        u, n = noise
        X = u.shape[0]
        state = ManyAntState(q=self.q0 + _uniform(u, RESET_NOISE), qd=RESET_NOISE * n,
                             t=torch.zeros(X, dtype=torch.int32, device=self.device))
        no = torch.zeros(X, dtype=torch.bool, device=self.device)
        return state, self._timestep(state, torch.zeros(X, device=self.device), no, no)

    def step(self, state: ManyAntState, actions: torch.Tensor):
        """actions (X, N, 4·M) in [−1, 1] (manyagent_ant.py:322-343)."""
        flat = actions.reshape(actions.shape[0], -1)
        q, qd, contact_n = self.physics_step(state.q, state.qd, flat)
        vel_x = (q[:, 0] - state.q[:, 0]) / (DT * FRAME_SKIP)
        ctrl = CTRL_COST * (torch.clamp(flat, -1.0, 1.0) ** 2).sum(dim=1)
        healthy = self._is_healthy(q, qd)
        reward = (vel_x + HEALTHY_REWARD * healthy.to(q.dtype) - ctrl
                  - CONTACT_COST * contact_n ** 2)
        new_t = state.t + 1
        trunc = new_t >= self.episode_limit
        term = ~healthy
        new_state = ManyAntState(q=q, qd=qd, t=new_t)
        return new_state, self._timestep(new_state, reward, term | trunc, trunc & ~term)

    def _is_healthy(self, q: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
        ok = (q[:, 2] > HEALTHY_Z[0]) & (q[:, 2] < HEALTHY_Z[1])
        ok = ok & (torch.linalg.vector_norm(q[:, 3:6], dim=1) < ROTVEC_MAX)
        return ok & torch.isfinite(q).all(dim=1) & torch.isfinite(qd).all(dim=1)

    # ---------------------------------------------------------- observation
    def _timestep(self, state: ManyAntState, reward, done, bad) -> TimeStep:
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
            bad_transition=bad,
        )


def make_manyagent_ant(env_args: dict, device: torch.device) -> ManyAgentAnt:
    n_agents, segs = (int(x) for x in env_args.get("agent_conf", "2x3").split("x"))
    return ManyAgentAnt(n_agents=n_agents, segs_per_agent=segs,
                        episode_limit=env_args.get("episode_limit", 1000), device=device)
