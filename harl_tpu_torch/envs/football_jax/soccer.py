"""Pure-tensor academy soccer for the port (counterpart of
``harl_tpu/envs/football_jax/soccer.py``), the Google Research Football
academy analogue, stepped as a batch of X instances on one device.

A 2D pitch in GRF coordinates (x ∈ [−1, 1], y ∈ [−0.42, 0.42], the goal at
x = 1 with |y| < 0.044): N left-team agents with Discrete(19) GRF actions
(idle, 8 moves, long/high/short pass, shot, sprint and its release; the
other ids are no-ops), M scripted right-team players (ball-chasing
defenders at the scenario's ``chase`` speed, the last one a goal-line
keeper), a ball that is loose (friction 0.95 a step) or follows its carrier,
kicks toward the goal or the nearest teammate, takes within 0.02 (the left
team wins a tie), steals within 0.015, and a keeper save when a loose
ball's path passes within 0.025 of the keeper. The team reward is +1 on a
goal plus the ``checkpoints`` shaping: 0.1 the first time the ball, held by
the team, enters each of 10 rings around the goal, and the rings left on a
goal. An episode ends on a goal, the ball out, a loss of possession, or by
truncation at ``episode_limit`` (``bad_transition``); ``won`` is the goal.
All 8 academy ``SCENARIOS`` of the JAX env are here, the 10-vs-11
``single_goal_versus_lazy`` included.

Observations are the ``simple`` vectors (own position, velocity and sprint,
teammates and defenders relative, the ball, the possession one-hot and
whether the agent carries) or, with ``representation: pixels``, the
super-minimap rasters (N, 24, 32, 4) of [teammates, opponents, ball, self]
at 255. The share_obs is the Simple115-style global state.

Where an index can run past a team (``carrier`` of the right team read on
the left, as JAX's clamping gather allows), it is clamped explicitly, since
a CUDA gather would assert. Possession, steals, saves and the checkpoint
ring are decided by comparisons on distances, so those distances are
rounded as XLA's CPU backend rounds them (``_norm``, ``_fma``: a product
fused into the add that takes it), and divisions by constants are
multiplications by their float32 reciprocals.

``step`` draws no random numbers. ``reset`` takes three standard normal
draws (``reset_noise_spec``): the attackers' x and y jitter and the
outfield defenders' x jitter; the spawn lines are ``linspace32``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from harl_tpu_torch.envs.core import TimeStep, linspace32
# the rounding of XLA's CPU backend, as SMACLite matches it
from harl_tpu_torch.envs.smaclite.smaclite import _fma, _norm, _recip
from harl_tpu_torch.utils import spaces

PLAYER_SPEED = 0.012       # field units / step
SPRINT_MULT = 1.5
BALL_FRICTION = 0.95
POSSESS_RADIUS = 0.02
STEAL_RADIUS = 0.015
SHOT_POWER = 0.06
LONG_PASS_POWER = 0.045
SHORT_PASS_POWER = 0.03
GOAL_X, GOAL_HALF_W = 1.0, 0.044
FIELD_Y = 0.42

# GRF action ids
IDLE = 0
MOVE0 = 1                   # 1..8: L, TL, T, TR, R, BR, B, BL
LONG_PASS, HIGH_PASS, SHORT_PASS, SHOT = 9, 10, 11, 12
SPRINT, REL_DIR, REL_SPRINT, SLIDE, DRIBBLE, REL_DRIBBLE = 13, 14, 15, 16, 17, 18
N_ACTIONS = 19

_DIRS = np.array([[-1, 0], [-1, 1], [0, 1], [1, 1], [1, 0], [1, -1], [0, -1], [-1, -1]],
                 dtype=np.float64)
_DIRS = (_DIRS / np.linalg.norm(_DIRS, axis=1, keepdims=True)).astype(np.float32)

SCENARIOS = {
    # name: (n_agents, n_defenders incl. keeper, attacker spawn x, chase,
    #        outfield-defender spawn x, defender y half-spread)
    "academy_3_vs_1_with_keeper": (3, 2, 0.45, 1.05, 0.75, 0.05),
    "academy_pass_and_shoot_with_keeper": (2, 2, 0.45, 1.05, 0.75, 0.05),
    "academy_run_pass_and_shoot_with_keeper": (2, 2, 0.45, 1.05, 0.75, 0.05),
    "academy_counterattack_easy": (4, 2, 0.45, 1.05, 0.75, 0.05),
    "academy_counterattack_hard": (4, 3, 0.45, 1.05, 0.875, 0.15),
    "academy_corner": (4, 3, 0.45, 1.05, 0.75, 0.05),
    "academy_run_to_score_with_keeper": (1, 1, -0.3, 1.05, 0.9, 0.15),
    "academy_single_goal_versus_lazy": (10, 11, 0.0, 0.0, 0.65, 0.15),
}

SMM_H, SMM_W = 24, 32       # super-minimap raster (football_env.py:34-35)


def _dot2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a₀b₀ + a₁b₁ over the last axis, the second product fused (as ``_norm``)."""
    return _fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0])


class SoccerState(NamedTuple):
    left_pos: torch.Tensor     # (X, N, 2) agents
    left_vel: torch.Tensor
    right_pos: torch.Tensor    # (X, M, 2) scripted defenders; the last is the keeper
    right_vel: torch.Tensor
    ball_pos: torch.Tensor     # (X, 2)
    ball_vel: torch.Tensor
    owner: torch.Tensor        # (X,) int32: 0 loose, 1 left, 2 right
    carrier: torch.Tensor      # (X,) int32 index within the owning team
    checkpoints: torch.Tensor  # (X, 10) bool: collected shaping rings
    sprint: torch.Tensor       # (X, N) bool
    t: torch.Tensor            # (X,) int32


class AcademySoccer:
    """One academy scenario over a batch of envs (``make_soccer``)."""

    metric_keys = ("won",)

    def __init__(self, n_agents: int = 3, n_defenders: int = 2, episode_limit: int = 400,
                 rewards: str = "scoring,checkpoints", representation: str = "simple",
                 spawn_x: float = 0.45, chase: float = 1.05, def_spawn_x: float = 0.75,
                 def_spread: float = 0.05, device: torch.device = torch.device("cpu")):
        if representation not in ("simple", "pixels"):
            raise ValueError(f"unknown representation {representation!r}: simple or pixels")
        self.n_agents, self.n_defenders = n_agents, n_defenders
        self.episode_limit = episode_limit
        self.rewards = rewards
        self.representation = representation
        self.spawn_x, self.chase = spawn_x, chase
        self.def_spawn_x, self.def_spread = def_spawn_x, def_spread
        self.device = torch.device(device)
        N, M = n_agents, n_defenders
        f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        self.dirs = f(_DIRS)
        self.ly = f(linspace32(-0.15, 0.15, N))
        self.dy = f(linspace32(-def_spread, def_spread, max(M - 1, 1))[: M - 1])
        self.keeper0 = f([[0.99, 0.0]])
        self.goal = f([GOAL_X, 0.0])
        self.rings = torch.arange(10, device=self.device)
        # agent i's teammates j ≠ i
        self.mates = torch.as_tensor([[j for j in range(N) if j != i] for i in range(N)],
                                     dtype=torch.long, device=self.device).reshape(N, N - 1)
        self.agent_idx = torch.arange(N, device=self.device)

    @property
    def obs_dim(self) -> int:
        return 5 + 4 * (self.n_agents - 1) + 4 * self.n_defenders + 4 + 3 + 1

    @property
    def state_dim(self) -> int:
        return 4 * self.n_agents + 4 * self.n_defenders + 4 + 3

    @property
    def reset_noise_spec(self):
        """Standard normals: attackers' x, their y, outfield defenders' x."""
        N = self.n_agents
        return (("normal", N), ("normal", N), ("normal", self.n_defenders - 1))

    @property
    def observation_space(self):
        if self.representation == "pixels":
            return [spaces.ImageBox(SMM_H, SMM_W, 4)] * self.n_agents
        return [spaces.Box.create(-np.inf, np.inf, self.obs_dim)] * self.n_agents

    @property
    def share_observation_space(self):
        return [spaces.Box.create(-np.inf, np.inf, self.state_dim)] * self.n_agents

    @property
    def action_space(self):
        return [spaces.Discrete(N_ACTIONS)] * self.n_agents

    # ------------------------------------------------------------------ api
    def reset(self, noise) -> Tuple[SoccerState, TimeStep]:
        """Attackers on their spawn line with the ball at agent 0's feet,
        outfield defenders between them and the goal, the keeper on the
        line (soccer.py:143-170)."""
        n1, n2, n3 = noise
        X, N, M = n1.shape[0], self.n_agents, self.n_defenders
        left = torch.stack([self.spawn_x + 0.05 * n1, self.ly + 0.02 * n2], dim=-1)
        defs = torch.stack([self.def_spawn_x + 0.03 * n3, self.dy.expand(X, -1)], dim=-1)
        right = torch.cat([defs, self.keeper0.expand(X, 1, 2)], dim=1)
        zeros = lambda *s: torch.zeros(s, device=self.device)
        ball = left[:, 0] + torch.tensor([0.01, 0.0], device=self.device)
        state = SoccerState(
            left_pos=left, left_vel=zeros(X, N, 2), right_pos=right, right_vel=zeros(X, M, 2),
            ball_pos=ball, ball_vel=zeros(X, 2),
            owner=torch.ones(X, dtype=torch.int32, device=self.device),
            carrier=torch.zeros(X, dtype=torch.int32, device=self.device),
            checkpoints=torch.zeros((X, 10), dtype=torch.bool, device=self.device),
            sprint=torch.zeros((X, N), dtype=torch.bool, device=self.device),
            t=torch.zeros(X, dtype=torch.int32, device=self.device))
        no = torch.zeros(X, dtype=torch.bool, device=self.device)
        return state, self._timestep(state, zeros(X), no, no, zeros(X))

    def step(self, state: SoccerState, actions: torch.Tensor):
        """actions (X, N, 1) GRF ids (soccer.py:172-280)."""
        X, N, M = state.left_pos.shape[0], self.n_agents, self.n_defenders
        acts = actions.reshape(X, N).long()
        rows = torch.arange(X, device=self.device)

        # movement
        moving = (acts >= MOVE0) & (acts <= MOVE0 + 7)
        sprint = torch.where(acts == SPRINT, True,
                             torch.where(acts == REL_SPRINT, False, state.sprint))
        dirs = self.dirs[torch.clamp(acts - MOVE0, 0, 7)] * moving[..., None]
        speed = PLAYER_SPEED * torch.where(sprint, SPRINT_MULT, 1.0)[..., None]
        # a player not issuing a move keeps drifting (GRF sticky directions)
        vel = torch.where(moving[..., None], dirs * speed, state.left_vel * 0.9)
        lp = state.left_pos + vel
        left_pos = torch.stack([torch.clamp(lp[..., 0], -1.0, 1.0),
                                torch.clamp(lp[..., 1], -FIELD_Y, FIELD_Y)], dim=-1)

        # scripted defence: outfield players chase the ball, the keeper
        # tracks it along the goal line
        ball = state.ball_pos
        chase = ball[:, None] - state.right_pos[:, : M - 1]
        chase = chase / (_norm(chase) + 1e-8)[..., None]
        # XLA folds PLAYER_SPEED·chase into one constant and fuses the
        # product into the position update
        speed_d = float(np.float32(PLAYER_SPEED) * np.float32(self.chase))
        dvel = chase * speed_d
        keeper_y = torch.clamp(ball[:, 1], -GOAL_HALF_W, GOAL_HALF_W)
        kvel = torch.stack([torch.zeros_like(keeper_y), torch.clamp(
            keeper_y - state.right_pos[:, -1, 1], -PLAYER_SPEED, PLAYER_SPEED)], dim=-1)
        right_vel = torch.cat([dvel, kvel[:, None]], dim=1)
        right_pos = torch.cat([_fma(chase, speed_d, state.right_pos[:, : M - 1]),
                               state.right_pos[:, -1:] + kvel[:, None]], dim=1)

        # kicks by the carrier; the left-team index is clamped where the
        # right team holds the ball (JAX's gathers clamp there)
        owner, carrier = state.owner, state.carrier.long()
        c_left = torch.clamp(carrier, max=N - 1)
        held = owner == 1
        carrier_left_pos = left_pos[rows, c_left]
        carrier_pos = torch.where(held[:, None], carrier_left_pos, ball)
        to_goal = self.goal - carrier_pos
        to_goal = to_goal / (_norm(to_goal) + 1e-8)[:, None]
        dmat = _norm(left_pos - carrier_pos[:, None])
        # the carrier is no pass target (a right-team index sets nothing)
        dmat = torch.where((self.agent_idx == carrier[:, None]), 1e9, dmat)
        mate = torch.argmin(dmat, dim=1)
        to_mate = left_pos[rows, mate] - carrier_pos
        to_mate = to_mate / (_norm(to_mate) + 1e-8)[:, None]
        act_c = acts[rows, c_left]
        is_shot = (act_c == SHOT) & held
        is_long = ((act_c == LONG_PASS) | (act_c == HIGH_PASS)) & held
        is_short = (act_c == SHORT_PASS) & held
        kicked = is_shot | is_long | is_short
        kick_vel = torch.where(is_shot[:, None], SHOT_POWER * to_goal,
                               torch.where(is_long[:, None], LONG_PASS_POWER * to_mate,
                                           SHORT_PASS_POWER * to_mate))

        # the ball follows its carrier unless loose or just kicked
        loose = (owner == 0)[:, None]
        ball_vel = torch.where(kicked[:, None], kick_vel,
                               torch.where(loose, state.ball_vel * BALL_FRICTION, 0.0))
        right_holder = right_pos[rows, torch.clamp(carrier, max=M - 1)]
        ball_pos = torch.where(kicked[:, None] | loose, ball + ball_vel,
                               torch.where(held[:, None], _fma(to_goal, 0.01, carrier_left_pos),
                                           right_holder))
        owner = torch.where(kicked, 0, owner)

        # possession changes
        dl = _norm(left_pos - ball_pos[:, None])
        dr = _norm(right_pos - ball_pos[:, None])
        near_l, near_r = dl.min(dim=1).values, dr.min(dim=1).values
        free = owner == 0
        take_l = free & (near_l < POSSESS_RADIUS) & (near_l <= near_r)
        take_r = free & (near_r < POSSESS_RADIUS) & (near_r < near_l)
        steal_r = (owner == 1) & (near_r < STEAL_RADIUS)
        # keeper save: a loose ball whose path segment passes close to the
        # keeper is caught even at shot speed
        seg = ball_pos - ball
        seg_len2 = _dot2(seg, seg) + 1e-12
        tproj = torch.clamp(_dot2(right_pos[:, -1] - ball, seg) / seg_len2, 0.0, 1.0)
        closest = _fma(tproj[:, None], seg, ball)
        keeper_save = free & (_norm(right_pos[:, -1] - closest) < 0.025)
        new_owner = torch.where(take_l, 1, torch.where(take_r | steal_r | keeper_save, 2, owner))
        new_carrier = torch.where(new_owner == 1, torch.argmin(dl, dim=1),
                                  torch.where(new_owner == 2, torch.argmin(dr, dim=1), carrier))

        # scoring and termination
        bx, by = ball_pos[:, 0], ball_pos[:, 1]
        goal_scored = (bx >= GOAL_X) & (by.abs() < GOAL_HALF_W)
        out = (by.abs() > FIELD_Y) | (bx <= -1.0) | ((bx >= GOAL_X) & ~goal_scored)
        lost = new_owner == 2
        new_t = state.t + 1
        trunc = new_t >= self.episode_limit
        ended = goal_scored | out | lost

        # reward: scoring + checkpoints
        reward = goal_scored.to(torch.float32)
        checkpoints = state.checkpoints
        if "checkpoints" in self.rewards:
            d_goal = _norm(ball_pos - self.goal)
            ring = torch.clamp((10.0 * (1.0 - d_goal)).to(torch.int32), 0, 9)
            reach = (self.rings <= ring[:, None]) & (new_owner == 1)[:, None]
            fresh = reach & ~checkpoints
            reward = reward + 0.1 * fresh.to(torch.float32).sum(dim=1)
            # on a goal, GRF grants every remaining checkpoint
            left_over = (~(checkpoints | fresh)).to(torch.float32).sum(dim=1)
            reward = reward + 0.1 * torch.where(goal_scored, left_over, 0.0)
            checkpoints = checkpoints | fresh

        new_state = SoccerState(
            left_pos=left_pos, left_vel=vel, right_pos=right_pos, right_vel=right_vel,
            ball_pos=ball_pos, ball_vel=ball_vel, owner=new_owner.to(torch.int32),
            carrier=new_carrier.to(torch.int32), checkpoints=checkpoints, sprint=sprint,
            t=new_t)
        return new_state, self._timestep(new_state, reward, ended | trunc, trunc & ~ended,
                                         goal_scored.to(torch.float32))

    # ---------------------------------------------------------- observation
    def _pixel_obs(self, state: SoccerState) -> torch.Tensor:
        """(X, N, H, W, 4) rasters: [teammates, opponents, ball, self] at
        255 (soccer.py:286-306)."""
        X, N = state.left_pos.shape[0], self.n_agents

        def cells(pos):   # pitch x ∈ [−1.05, 1.05], y ∈ [−0.45, 0.45] → row·W + col
            col = ((pos[..., 0] + 1.05) * _recip(2.1) * (SMM_W - 1)).to(torch.int32)
            row = ((pos[..., 1] + 0.45) * _recip(0.9) * (SMM_H - 1)).to(torch.int32)
            return (torch.clamp(row, 0, SMM_H - 1) * SMM_W + torch.clamp(col, 0, SMM_W - 1)).long()

        def paint(idx):   # idx (X, K) → (X, H·W) with 255 at those cells
            return torch.zeros((X, SMM_H * SMM_W), device=self.device).scatter_(1, idx, 255.0)

        left = cells(state.left_pos)
        shared = torch.stack([paint(left), paint(cells(state.right_pos)),
                              paint(cells(state.ball_pos)[:, None])], dim=-1)   # (X, HW, 3)
        me = F.one_hot(left, SMM_H * SMM_W).to(torch.float32) * 255.0          # (X, N, HW)
        obs = torch.cat([shared[:, None].expand(X, N, -1, 3), me[..., None]], dim=-1)
        return obs.reshape(X, N, SMM_H, SMM_W, 4)

    def _timestep(self, state: SoccerState, reward, done, bad, scored) -> TimeStep:
        X, N, M = state.left_pos.shape[0], self.n_agents, self.n_defenders
        own_flags = F.one_hot(state.owner.long(), 3).to(torch.float32)
        share = torch.cat([state.left_pos.reshape(X, -1), state.left_vel.reshape(X, -1),
                           state.right_pos.reshape(X, -1), state.right_vel.reshape(X, -1),
                           state.ball_pos, state.ball_vel, own_flags], dim=1)
        if self.representation == "pixels":
            obs = self._pixel_obs(state)
        else:
            me = state.left_pos[:, :, None]                                    # (X, N, 1, 2)
            mates = torch.cat([state.left_pos[:, self.mates] - me,
                               state.left_vel[:, self.mates]], dim=-1)         # (X, N, N-1, 4)
            defs = torch.cat([state.right_pos[:, None] - me,
                              state.right_vel[:, None].expand(X, N, M, 2)], dim=-1)
            carries = (state.owner[:, None] == 1) & (state.carrier[:, None] == self.agent_idx)
            obs = torch.cat([
                state.left_pos, state.left_vel, state.sprint[..., None].to(torch.float32),
                mates.reshape(X, N, -1), defs.reshape(X, N, -1),
                state.ball_pos[:, None] - state.left_pos,
                state.ball_vel[:, None].expand(X, N, 2), own_flags[:, None].expand(X, N, 3),
                carries[..., None].to(torch.float32)], dim=-1)
        return TimeStep(
            obs=obs,
            share_obs=share,
            rewards=reward[:, None, None].expand(X, N, 1),
            dones=done[:, None].expand(X, N),
            bad_transition=bad,
            available_actions=torch.ones((X, N, N_ACTIONS), device=self.device),
            metrics={"won": scored},
        )


def make_soccer(env_args: dict, device: torch.device) -> AcademySoccer:
    """``env_name`` (or ``scenario``) picks the academy scenario
    (soccer.py:345-360)."""
    scenario = env_args.get("env_name", env_args.get("scenario", "academy_3_vs_1_with_keeper"))
    if scenario not in SCENARIOS:
        raise ValueError(f"Unknown academy scenario {scenario!r}; available: {sorted(SCENARIOS)}")
    n_agents, n_defs, spawn_x, chase, def_x, def_spread = SCENARIOS[scenario]
    return AcademySoccer(
        n_agents=env_args.get("num_agents", n_agents), n_defenders=n_defs,
        episode_limit=env_args.get("episode_limit", 400),
        rewards=env_args.get("rewards", "scoring,checkpoints"),
        representation=env_args.get("representation", "simple"),
        spawn_x=spawn_x, chase=chase, def_spawn_x=def_x, def_spread=def_spread, device=device)
