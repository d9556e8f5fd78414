"""Pure-tensor multi-aircraft air combat for the port (counterpart of
``harl_tpu/envs/lag_jax/aircombat.py``), the LAG/CloseAirCombat analogue,
stepped as a batch of X instances on one device.

N allied agents fly against E scripted enemies on the 3-DoF point-mass
flight model of the JAX env (its module docstring gives the reference
anchors):

    v̇ = (T·thr − k_d v²)/m − g sin γ          thrust, drag, gravity
    γ′ = γ + clip(γ_cmd − γ, ±0.3·dt)           rate-limited climb angle
    ψ′ = ψ + dt·turn·min(1, v_ref/v′)           load-factor-limited turn
    p′ = p + dt·v′·alive·(cos γ′ cos ψ′, cos γ′ sin ψ′, sin γ′)

MultiDiscrete([11, 11, 10]) actions bin the turn, climb and throttle
commands. The enemies pursue the nearest living ally (the first on a tie)
and match its altitude at a handicapped turn rate. A target inside a
shooter's gun envelope (range below 1000 m, aspect angle below 0.35 rad)
loses 0.2 health a step per hostile living shooter; an aircraft dies at
zero health or outside the altitude band. The team reward is the posture
term Σ (1 − ao/π)·exp(−range/3000) over living ally-enemy pairs over N,
±20 an enemy or ally downed, +200 on a win. An episode ends when a team is
gone or by truncation at ``episode_limit`` (``bad_transition`` only when
neither team is gone). A downed ally is done on its own, which clears its
active mask; the env is done when every ally is.

``step`` draws no random numbers. ``reset`` takes three standard normal
draws (``reset_noise_spec``): the allies' x jitter, the enemies', and every
aircraft's altitude jitter. The y lines are ``linspace32``: equal to the
JAX env's jitted ``jnp.linspace`` for up to 7 aircraft a side, within two
float32 ulps of 1000 m beyond (as SMACLite's spawn lines, ROADMAP Queue C).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from harl_tpu_torch.envs.core import TimeStep, linspace32
from harl_tpu_torch.envs.smaclite.smaclite import _recip   # XLA's x / c is x·(1/c)
from harl_tpu_torch.utils import spaces

DT = 0.2                      # s per control step
G = 9.81
MASS = 9000.0                 # kg
T_MAX = 160000.0              # N max thrust
K_DRAG = 2.2                  # N/(m/s)^2
V_MIN, V_MAX = 60.0, 340.0    # m/s
V_REF = 200.0                 # turn-rate reference speed
TURN_MAX = 0.35               # rad/s at V_REF
GAMMA_MAX = 0.5               # rad max climb angle
GAMMA_RATE = 0.3              # rad/s toward command
ALT_MIN, ALT_MAX = 100.0, 12000.0
GUN_RANGE = 1000.0            # m
GUN_AO = 0.35                 # rad
GUN_DPS = 1.0                 # health/s in the envelope
TURN_BINS, CLIMB_BINS, THR_BINS = 11, 11, 10


class AirCombatState(NamedTuple):
    pos: torch.Tensor     # (X, A, 3) all aircraft, allies first
    v: torch.Tensor       # (X, A)
    psi: torch.Tensor     # (X, A) heading
    gamma: torch.Tensor   # (X, A) climb angle
    health: torch.Tensor  # (X, A)
    alive: torch.Tensor   # (X, A) bool
    t: torch.Tensor       # (X,) int32


def _norm(x: torch.Tensor) -> torch.Tensor:
    """√(Σ x²) over the last axis, as ``jnp.linalg.norm`` forms it."""
    return torch.sqrt((x * x).sum(dim=-1))


class AirCombat:
    """``n_allies`` agents against ``n_enemies`` scripted aircraft."""

    metric_keys = ("won",)

    def __init__(self, n_allies: int = 2, n_enemies: int = 2, episode_limit: int = 500,
                 enemy_skill: float = 0.5, device: torch.device = torch.device("cpu")):
        self.n_allies, self.n_enemies = n_allies, n_enemies
        self.episode_limit = episode_limit
        self.enemy_skill = enemy_skill
        self.device = torch.device(device)
        N, E = n_allies, n_enemies
        f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        self.ay, self.ey = (f(linspace32(-1000.0, 1000.0, n)) for n in (N, E))
        self.psi0 = f(np.concatenate([np.zeros(N), np.full(E, np.pi)]))
        team = np.concatenate([np.zeros(N), np.ones(E)])
        self.hostile = f(team[:, None] != team[None, :])
        self.mates = torch.as_tensor([[j for j in range(N) if j != i] for i in range(N)],
                                     dtype=torch.long, device=self.device).reshape(N, N - 1)
        self.rows = torch.arange(N, device=self.device)[:, None]

    @property
    def n_agents(self) -> int:
        return self.n_allies

    @property
    def A(self) -> int:
        return self.n_allies + self.n_enemies

    @property
    def obs_dim(self) -> int:
        return 7 + 6 * (self.n_allies - 1) + 9 * self.n_enemies

    @property
    def state_dim(self) -> int:
        return 7 * self.A

    @property
    def reset_noise_spec(self):
        """Standard normals: allies' x, enemies' x, every altitude."""
        return (("normal", self.n_allies), ("normal", self.n_enemies), ("normal", self.A))

    @property
    def observation_space(self):
        return [spaces.Box.create(-np.inf, np.inf, self.obs_dim)] * self.n_allies

    @property
    def share_observation_space(self):
        return [spaces.Box.create(-np.inf, np.inf, self.state_dim)] * self.n_allies

    @property
    def action_space(self):
        return [spaces.MultiDiscrete((TURN_BINS, CLIMB_BINS, THR_BINS))] * self.n_allies

    # ------------------------------------------------------------------ api
    def reset(self, noise) -> Tuple[AirCombatState, TimeStep]:
        """Allies head east from x ≈ −5000, enemies west from x ≈ 5000, at
        ~5000 m (aircombat.py:122-146)."""
        na, ne, nv = noise
        X, N, E = na.shape[0], self.n_allies, self.n_enemies
        x = torch.cat([-5000.0 + 500.0 * na, 5000.0 + 500.0 * ne], dim=1)
        y = torch.cat([self.ay, self.ey]).expand(X, -1)
        pos = torch.stack([x, y, 5000.0 + 300.0 * nv], dim=-1)
        A = N + E
        state = AirCombatState(
            pos=pos, v=torch.full((X, A), 220.0, device=self.device),
            psi=self.psi0.expand(X, -1).clone(), gamma=torch.zeros((X, A), device=self.device),
            health=torch.ones((X, A), device=self.device),
            alive=torch.ones((X, A), dtype=torch.bool, device=self.device),
            t=torch.zeros(X, dtype=torch.int32, device=self.device))
        no = torch.zeros(X, dtype=torch.bool, device=self.device)
        zero = torch.zeros(X, device=self.device)
        return state, self._timestep(state, zero, no, no, zero)

    def step(self, state: AirCombatState, actions: torch.Tensor):
        """actions (X, N, 3) bin indices (aircombat.py:148-224)."""
        N = self.n_allies
        acts = actions.reshape(-1, N, 3)
        acts = acts.to(torch.float32)
        turn_a = (acts[..., 0] * _recip(TURN_BINS - 1) * 2.0 - 1.0) * TURN_MAX
        gam_a = (acts[..., 1] * _recip(CLIMB_BINS - 1) * 2.0 - 1.0) * GAMMA_MAX
        thr_a = acts[..., 2] * _recip(THR_BINS - 1)
        turn_e, gam_e, thr_e = self._enemy_ai(state)
        turn = torch.cat([turn_a, turn_e], dim=1)
        gam_cmd = torch.cat([gam_a, gam_e], dim=1)
        thr = torch.cat([thr_a, thr_e], dim=1)

        # point-mass dynamics
        alive_f = state.alive.to(torch.float32)
        v = state.v
        vdot = (T_MAX * thr - K_DRAG * v * v) * _recip(MASS) - G * torch.sin(state.gamma)
        v_new = torch.clamp(v + DT * vdot, V_MIN, V_MAX)
        gamma_new = state.gamma + torch.clamp(gam_cmd - state.gamma,
                                              -GAMMA_RATE * DT, GAMMA_RATE * DT)
        psi_new = state.psi + DT * turn * torch.clamp(V_REF / v_new, max=1.0)
        cg = torch.cos(gamma_new)
        dirv = torch.stack([cg * torch.cos(psi_new), cg * torch.sin(psi_new),
                            torch.sin(gamma_new)], dim=-1)
        pos_new = state.pos + DT * (v_new * alive_f)[..., None] * dirv

        # gun engagements: shooter i, target j on opposite teams
        rel = pos_new[:, None, :, :] - pos_new[:, :, None, :]            # (X, A, A, 3)
        rng = _norm(rel) + 1e-6
        cos_ao = (rel * dirv[:, :, None, :]).sum(dim=-1) / rng
        ao = torch.arccos(torch.clamp(cos_ao, -1.0, 1.0))
        both_alive = alive_f[:, :, None] * alive_f[:, None, :]
        in_env = ((rng < GUN_RANGE) & (ao < GUN_AO)).to(torch.float32)
        dmg = GUN_DPS * DT * (in_env * self.hostile * both_alive).sum(dim=1)
        health_new = torch.clamp(state.health - dmg, 0.0, 1.0)
        alt_ok = (pos_new[..., 2] > ALT_MIN) & (pos_new[..., 2] < ALT_MAX)
        alive_new = state.alive & (health_new > 0.0) & alt_ok

        # reward: posture shaping, events and the win bonus
        adv = ((1.0 - ao[:, :N, N:] * _recip(math.pi))
               * torch.exp(-rng[:, :N, N:] * _recip(3000.0)) * both_alive[:, :N, N:])
        posture = adv.sum(dim=(1, 2)) * _recip(max(N, 1))
        downed = (state.alive & ~alive_new).to(torch.float32)
        win = ~alive_new[:, N:].any(dim=1)
        lose = ~alive_new[:, :N].any(dim=1)
        reward = (1.0 * posture + 20.0 * downed[:, N:].sum(dim=1)
                  - 20.0 * downed[:, :N].sum(dim=1) + 200.0 * win.to(torch.float32))

        new_t = state.t + 1
        trunc = new_t >= self.episode_limit
        ended = win | lose
        new_state = AirCombatState(pos=pos_new, v=v_new, psi=psi_new, gamma=gamma_new,
                                   health=health_new, alive=alive_new, t=new_t)
        return new_state, self._timestep(new_state, reward, ended | trunc, trunc & ~ended,
                                         win.to(torch.float32))

    def _enemy_ai(self, state: AirCombatState):
        """Pure pursuit of the nearest living ally, altitude matching, 0.9
        throttle (aircombat.py:203-222)."""
        N = self.n_allies
        epos, apos = state.pos[:, N:], state.pos[:, :N]
        rel = apos[:, None, :, :] - epos[:, :, None, :]                   # (X, E, N, 3)
        rng = _norm(rel) + 1e-6
        rng_masked = torch.where(state.alive[:, None, :N], rng, 1e9)
        tgt = torch.argmin(rng_masked, dim=2)                             # (X, E)
        tvec = torch.take_along_dim(rel, tgt[..., None, None], dim=2)[:, :, 0]
        brg = torch.atan2(tvec[..., 1], tvec[..., 0])
        d = brg - state.psi[:, N:]
        dpsi = torch.atan2(torch.sin(d), torch.cos(d))
        max_turn = self.enemy_skill * TURN_MAX
        turn = torch.clamp(dpsi * _recip(DT), -max_turn, max_turn)
        gam = torch.clamp(torch.atan2(tvec[..., 2], _norm(tvec[..., :2])),
                          -GAMMA_MAX, GAMMA_MAX)
        return turn, gam, torch.full_like(turn, 0.9)

    # ---------------------------------------------------------- observation
    def _timestep(self, state: AirCombatState, reward, done, bad, won) -> TimeStep:
        """Own 7 features, 6 per teammate and 9 per enemy, each entity's
        zeroed when it is down (aircombat.py:226-269)."""
        X, N, A = state.pos.shape[0], self.n_allies, self.A
        alive_f = state.alive.to(torch.float32)
        v_rel = state.v * _recip(V_MAX)
        own = torch.stack([state.pos[..., 2] * _recip(5000.0), v_rel, torch.sin(state.psi),
                           torch.cos(state.psi), state.gamma, state.health, alive_f], dim=-1)
        rel = state.pos[:, None, :, :] - state.pos[:, :, None, :]
        rng = _norm(rel) + 1e-6
        brg = torch.atan2(rel[..., 1], rel[..., 0])
        # teammates j of agent i: (X, N, N, 6), then each row without i
        ally_j = lambda x: x[:, None, :N, None].expand(X, N, N, 1)
        mates = torch.cat([rel[:, :N, :N] * _recip(5000.0), ally_j(torch.sin(state.psi)),
                           ally_j(torch.cos(state.psi)), ally_j(v_rel)],
                          dim=-1) * ally_j(alive_f)
        mates = mates[:, self.rows, self.mates].reshape(X, N, -1)
        foe_j = lambda x: x[:, None, N:, None].expand(X, N, A - N, 1)
        ao = (brg[:, :N, N:] - state.psi[:, :N, None])[..., None]
        foes = torch.cat([rel[:, :N, N:] * _recip(5000.0),
                          (rng[:, :N, N:] * _recip(5000.0))[..., None],
                          torch.sin(ao), torch.cos(ao), foe_j(v_rel), foe_j(state.health),
                          foe_j(alive_f)], dim=-1) * foe_j(alive_f)
        obs = torch.cat([own[:, :N], mates, foes.reshape(X, N, -1)], dim=-1)
        return TimeStep(
            obs=obs,
            share_obs=own.reshape(X, -1),
            rewards=reward[:, None, None].expand(X, N, 1),
            # a downed ally is done alone (active masks); the team ends together
            dones=done[:, None] | ~state.alive[:, :N],
            bad_transition=bad,
            metrics={"won": won},
        )


def make_aircombat(env_args: dict, device: torch.device) -> AirCombat:
    """``scenario`` "NvM" (also "…/NvM"); 2v2 otherwise (aircombat.py:272-279)."""
    scenario = env_args.get("scenario", "2v2")
    if "v" in scenario:
        n_allies, n_enemies = (int(x) for x in scenario.split("/")[-1].split("v"))
    else:
        n_allies, n_enemies = 2, 2
    return AirCombat(n_allies=n_allies, n_enemies=n_enemies,
                     episode_limit=env_args.get("episode_limit", 500),
                     enemy_skill=env_args.get("enemy_skill", 0.5), device=device)
