"""Multi-agent Particle Environments for the port (counterpart of
``harl_tpu/envs/mpe/mpe.py``): ``simple_spread``, ``simple_reference`` and
``simple_speaker_listener``, with continuous or discrete actions, stepped as
a batch of X instances on one device.

Physics of the MPE core integrator (dt 0.1, damping 0.25):

    u = (a[1] − a[2], a[3] − a[4]) · 5                 continuous moves
    f = 100 · Δp/‖Δp‖ · 1e-3 · softplus(−(‖Δp‖ − d_min)/1e-3)   soft-core contact
    v ← v·(1 − 0.25) + F·dt ;  p ← p + v·dt

The contact's softplus is ``logaddexp(x, 0)``, as ``jax.nn.softplus``
computes it. Episodes end only by truncation at ``max_cycles``, with
``bad_transition`` set; ``step`` draws no noise. The reward is the team's
sum repeated per agent, simple_spread's counting each agent's collision
with itself (−1 a step, as PettingZoo 1.22.2 does). Observations are padded
to the widest agent's (speaker-listener: 3 and 11), ``share_obs`` joins the
unpadded ones, and under discrete actions the availability rows are ones
over each agent's own actions and zeros on the padding.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from harl_tpu_torch.envs.core import TimeStep
from harl_tpu_torch.utils import spaces

DT = 0.1
DAMPING = 0.25
CONTACT_FORCE = 100.0
CONTACT_MARGIN = 1e-3
SENSITIVITY = 5.0
N_LANDMARKS = 3

LANDMARK_COLORS = ((0.75, 0.25, 0.25), (0.25, 0.75, 0.25), (0.25, 0.25, 0.75))

# per scenario: agents, comm width, agent sizes, movable, collide, obs widths
SCENARIOS = {
    "simple_spread": (3, 2, (0.15,) * 3, (True,) * 3, (True,) * 3, (18, 18, 18)),
    "simple_reference": (2, 10, (0.05, 0.05), (True, True), (False, False), (21, 21)),
    "simple_speaker_listener": (2, 3, (0.075, 0.075), (False, True), (False, False), (3, 11)),
}


class MPEState(NamedTuple):
    agent_pos: torch.Tensor     # (X, N, 2)
    agent_vel: torch.Tensor     # (X, N, 2)
    agent_comm: torch.Tensor    # (X, N, dim_c)
    landmark_pos: torch.Tensor  # (X, L, 2)
    goals: torch.Tensor         # (X, N) int64 landmark indices
    t: torch.Tensor             # (X,) int32


def _uniform(u: torch.Tensor, a: float) -> torch.Tensor:
    """U(−a, a) from u on [0, 1), as ``jax.random.uniform`` maps it."""
    return torch.clamp(u * (a - (-a)) + (-a), min=-a)


def _move_force(a_move: torch.Tensor) -> torch.Tensor:
    """(…, ≥5) action values → force (…, 2): (a1 − a2, a3 − a4)·5."""
    return torch.stack([a_move[..., 1] - a_move[..., 2],
                        a_move[..., 3] - a_move[..., 4]], dim=-1) * SENSITIVITY


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    return F.one_hot(idx, n).to(torch.float32)


def _dist(delta: torch.Tensor) -> torch.Tensor:
    """√(Σ Δ² + 1e-8) over the last axis."""
    return torch.sqrt((delta ** 2).sum(dim=-1) + 1e-8)


class MPE:
    """One scenario over a batch of envs (``make_mpe``)."""

    def __init__(self, scenario: str, continuous_actions: bool, device: torch.device,
                 max_cycles: int = 25, local_ratio: float = 0.5):
        if scenario not in SCENARIOS:
            raise ValueError(f"unknown MPE scenario {scenario!r}; available: {sorted(SCENARIOS)}")
        self.scenario = scenario
        self.continuous_actions = continuous_actions
        self.device = torch.device(device)
        self.max_cycles = max_cycles
        self.local_ratio = local_ratio
        (self.n_agents, self.dim_c, sizes, movable, collide,
         self.obs_dims) = SCENARIOS[scenario]
        self.sizes = torch.tensor(sizes, device=self.device)
        self.movable = torch.tensor(movable, device=self.device)
        self.collides = any(collide)
        self.colors = torch.tensor(LANDMARK_COLORS, device=self.device)
        N = self.n_agents
        self.not_self = ~torch.eye(N, dtype=torch.bool, device=self.device)
        if not continuous_actions:
            width = self.max_action_n
            self.avail = torch.stack([
                torch.cat([torch.ones(sp.n), torch.zeros(width - sp.n)])
                for sp in self.action_space]).to(self.device)

    # ----------------------------------------------------------- spaces
    @property
    def observation_space(self):
        return [spaces.Box.create(float("-inf"), float("inf"), d) for d in self.obs_dims]

    @property
    def share_observation_space(self):
        d = sum(self.obs_dims)
        return [spaces.Box.create(float("-inf"), float("inf"), d)] * self.n_agents

    @property
    def action_space(self):
        s, N = self.scenario, self.n_agents
        if self.continuous_actions:
            if s == "simple_spread":
                return [spaces.Box.create(0.0, 1.0, 5)] * N
            if s == "simple_reference":
                return [spaces.Box.create(0.0, 1.0, 5 + self.dim_c)] * N
            return [spaces.Box.create(0.0, 1.0, self.dim_c), spaces.Box.create(0.0, 1.0, 5)]
        if s == "simple_spread":
            return [spaces.Discrete(5)] * N
        if s == "simple_reference":
            return [spaces.Discrete(5 * self.dim_c)] * N
        return [spaces.Discrete(self.dim_c), spaces.Discrete(5)]

    @property
    def max_action_n(self) -> int:
        if self.continuous_actions:
            return max(sp.dim for sp in self.action_space)
        return max(sp.n for sp in self.action_space)

    @property
    def reset_noise_spec(self):
        """The agents' and the landmarks' uniforms, then (except in
        simple_spread) the goal landmarks' integers (mpe.py:176-195)."""
        spec = (("uniform", 2 * self.n_agents), ("uniform", 2 * N_LANDMARKS))
        if self.scenario != "simple_spread":
            spec += (("randint", self.n_agents, N_LANDMARKS),)
        return spec

    # -------------------------------------------------------------- api
    def reset(self, noise) -> Tuple[MPEState, TimeStep]:
        """``noise``: the draws of ``reset_noise_spec``: agents at U(−1, 1),
        landmarks at U(−0.9, 0.9), goals uniform over the landmarks."""
        X, N = noise[0].shape[0], self.n_agents
        goals = (noise[2].long() if self.scenario != "simple_spread"
                 else torch.zeros((X, N), dtype=torch.long, device=self.device))
        zeros = torch.zeros((X, N, 2), device=self.device)
        state = MPEState(
            agent_pos=_uniform(noise[0], 1.0).reshape(X, N, 2), agent_vel=zeros,
            agent_comm=torch.zeros((X, N, self.dim_c), device=self.device),
            landmark_pos=_uniform(noise[1], 0.9).reshape(X, N_LANDMARKS, 2), goals=goals,
            t=torch.zeros(X, dtype=torch.int32, device=self.device))
        return state, self._timestep(state, torch.zeros((X, N, 1), device=self.device),
                                     torch.zeros(X, dtype=torch.bool, device=self.device))

    def step(self, state: MPEState, actions: torch.Tensor) -> Tuple[MPEState, TimeStep]:
        """``actions``: (X, N, max width), continuous values or discrete
        indices in column 0, padded per agent."""
        move_force, comm = self._decode_actions(actions)
        force = move_force
        if self.collides:
            force = force + self._collision_forces(state.agent_pos)
        vel = state.agent_vel * (1.0 - DAMPING) + force * DT
        vel = torch.where(self.movable[:, None], vel, 0.0)
        new_state = state._replace(agent_pos=state.agent_pos + vel * DT, agent_vel=vel,
                                   agent_comm=comm, t=state.t + 1)
        return new_state, self._timestep(new_state, self._rewards(new_state),
                                         new_state.t >= self.max_cycles)

    # --------------------------------------------------------- dynamics
    def _decode_actions(self, actions: torch.Tensor):
        """(move force (X, N, 2), comm (X, N, dim_c))."""
        X, N, s = actions.shape[0], self.n_agents, self.scenario
        no_comm = torch.zeros((X, N, self.dim_c), device=self.device)
        if self.continuous_actions:
            if s == "simple_spread":
                return _move_force(actions), no_comm
            if s == "simple_reference":
                return _move_force(actions[..., :5]), actions[..., 5:]
            comm = torch.cat([actions[:, :1, : self.dim_c], no_comm[:, 1:]], dim=1)
            mf = torch.zeros((X, N, 2), device=self.device)
            mf[:, 1] = _move_force(actions[:, 1, :5])
            return mf, comm
        a = actions[..., 0].long()
        if s == "simple_spread":
            return _move_force(_one_hot(a, 5)), no_comm
        if s == "simple_reference":
            return _move_force(_one_hot(a % 5, 5)), _one_hot(a // 5, self.dim_c)
        comm = torch.cat([_one_hot(a[:, :1], self.dim_c), no_comm[:, 1:]], dim=1)
        mf = torch.zeros((X, N, 2), device=self.device)
        mf[:, 1] = _move_force(_one_hot(a[:, 1], 5))
        return mf, comm

    def _collision_forces(self, pos: torch.Tensor) -> torch.Tensor:
        """Soft-core forces between every pair of distinct agents (all of
        simple_spread's collide), summed per agent (mpe.py:71-90)."""
        delta = pos[:, :, None] - pos[:, None]                          # (X, N, N, 2)
        dist = _dist(delta)
        dist_min = self.sizes[:, None] + self.sizes[None, :]
        x = -(dist - dist_min) / CONTACT_MARGIN
        penetration = torch.logaddexp(x, torch.zeros_like(x)) * CONTACT_MARGIN
        fmag = torch.where(self.not_self, CONTACT_FORCE * penetration / dist, 0.0)
        return (fmag[..., None] * delta).sum(dim=2)

    def _rewards(self, state: MPEState) -> torch.Tensor:
        """(X, N, 1): the team reward repeated per agent (mpe.py:239-275)."""
        X, N, s = state.t.shape[0], self.n_agents, self.scenario
        pos, lm = state.agent_pos, state.landmark_pos
        if s == "simple_spread":
            d = torch.sqrt(((lm[:, :, None] - pos[:, None]) ** 2).sum(dim=-1))   # (X, L, N)
            global_rew = -d.min(dim=2).values.sum(dim=1)                          # (X,)
            coll = _dist(pos[:, :, None] - pos[:, None]) < (self.sizes[:, None]
                                                            + self.sizes[None, :])
            local = -coll.sum(dim=2).to(torch.float32)                            # (X, N)
            per_agent = (global_rew[:, None] * (1 - self.local_ratio)
                         + local * self.local_ratio)
            total = per_agent.sum(dim=1)
        elif s == "simple_reference":
            # agent i's reward: −dist²(the other agent, landmark goals[i])
            tgt = torch.gather(lm, 1, state.goals[..., None].expand(X, N, 2))
            total = (-((pos.flip(1) - tgt) ** 2).sum(dim=-1)).sum(dim=1)
        else:   # speaker-listener: −dist²(listener, goal) shared by both
            tgt = torch.gather(lm, 1, state.goals[:, :1, None].expand(X, 1, 2))[:, 0]
            total = -((pos[:, 1] - tgt) ** 2).sum(dim=-1) * N
        return total[:, None, None].expand(X, N, 1)

    # ------------------------------------------------------ observation
    def _obs(self, state: MPEState) -> torch.Tensor:
        """(X, N, max obs width), each agent's row zero-padded."""
        X, s = state.t.shape[0], self.scenario
        pos, vel, comm, lm = (state.agent_pos, state.agent_vel, state.agent_comm,
                              state.landmark_pos)
        lm_rel = (lm[:, None] - pos[:, :, None]).reshape(X, self.n_agents, -1)   # (X, N, 2L)
        if s == "simple_spread":
            rows = []
            for i in range(3):
                others = [j for j in range(3) if j != i]
                rows.append(torch.cat([vel[:, i], pos[:, i], lm_rel[:, i],
                                       (pos[:, others] - pos[:, i:i + 1]).reshape(X, -1),
                                       comm[:, others].reshape(X, -1)], dim=-1))
            return torch.stack(rows, dim=1)
        if s == "simple_reference":
            goal_color = self.colors[state.goals]                                # (X, N, 3)
            return torch.cat([vel, lm_rel, goal_color, comm.flip(1)], dim=-1)
        speaker = torch.cat([self.colors[state.goals[:, 0]],
                             torch.zeros((X, 8), device=self.device)], dim=-1)
        listener = torch.cat([vel[:, 1], lm_rel[:, 1], comm[:, 0]], dim=-1)
        return torch.stack([speaker, listener], dim=1)

    def _timestep(self, state: MPEState, rewards: torch.Tensor, done: torch.Tensor) -> TimeStep:
        obs = self._obs(state)
        X = obs.shape[0]
        return TimeStep(
            obs=obs,
            share_obs=torch.cat([obs[:, i, :d] for i, d in enumerate(self.obs_dims)], dim=-1),
            rewards=rewards,
            dones=done[:, None].expand(X, self.n_agents),
            bad_transition=done,   # MPE episodes end only by truncation
            available_actions=(None if self.continuous_actions
                               else self.avail.expand(X, *self.avail.shape)))


def make_mpe(scenario: str, device: torch.device, continuous_actions: bool = True,
             **kwargs) -> MPE:
    return MPE(scenario, continuous_actions, device, **kwargs)
