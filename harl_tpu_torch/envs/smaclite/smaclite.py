"""SMACLite for the port (counterpart of ``harl_tpu/envs/smaclite/smaclite.py``).

A StarCraft-style micromanagement env stepped as a batch of X instances on
one device: the JAX package's ``vmap`` becomes a leading env axis on every
state tensor. Mechanics, feature layouts, the map registry and the unit
tables are those of the JAX env (its module docstring lists them); see there
for the reference anchors.

Ported: the fixed-composition maps of the registry, the generic
``Nm_vs_Mm`` marine pattern, the SMACv2 randomized maps (``protoss_5_vs_5``,
``terran_10_vs_11``, ``zerg_20_vs_23`` …: the capability configs of
``configs/envs_cfgs/smacv2_map_config/*.yaml``, else the race named first),
EP and FP states, availability masks and the ``won`` / ``dead_allies`` /
``dead_enemies`` metrics.

A SMACv2 map draws each episode's unit types from its race pool with the
config's weights (a team of exception types only — terran medivacs, zerg
banelings — gets the heaviest other type for its unit 0) and its spawns
from two branches: with probability ``surround_p`` the allies cluster at
the centre with the enemies on a ring around them, otherwise both sides
spawn reflected at random. Every per-type quantity (health, shield,
cooldown, range, the type one-hot) is read per env from the state's unit
types; the medivac heal and the baneling splash run wherever the race pool
holds those types.

Bit-level agreement with the JAX env (the comparisons on distances are exact,
so a last-bit difference in a position can flip an availability bit):

* XLA fuses a product into the add that takes it (an FMA, also through a
  ``where``), in the norms, the chase and push-out steps and the push-out
  sum; the port forms those sums in float64 and rounds once (``_fma``,
  ``_norm``, ``_sum_over_units``);
* XLA turns a division by a constant into a multiplication by its float32
  reciprocal, so the port multiplies by ``_recip(c)`` (torch itself divides
  a CUDA tensor by a Python scalar through the reciprocal, a CPU tensor
  exactly);
* so every float operation of ``step`` and ``reset`` is an IEEE operation
  that rounds the same on the CPU and on a CUDA device;
* the spawn lines are ``np.linspace`` in float64 rounded to float32. The
  JAX env's jitted ``jnp.linspace`` differs from it by up to one float32
  ulp for some unit counts, so a fresh reset agrees to ~1e-7, not bitwise.

``step`` draws no random numbers. ``reset`` takes the draws of
``reset_noise_spec``: on a fixed map the (uniform [0, 1), normal) pair of
shape (X, 2A+2E), whose uniform part is the ally and enemy spawn jitter,
U(−1, 1) per coordinate; on a SMACv2 map one entry per draw of the JAX
reset. There a uniform on [lo, hi) is
``max(lo, u·(hi − lo) + lo)`` rounded once, as XLA fuses it; the weighted
type draw is ``jax.random.choice``'s (jax 0.9: ``searchsorted`` of
``cumsum(w)[-1]·(1 − u)`` in ``cumsum(w)``, the left side); the ring's cos and
sin are formed in float64 and rounded once, so the card and the CPU agree
bitwise (XLA's float32 cos and sin differ from them by an ulp now and then).
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from harl_tpu_torch.envs.core import TimeStep
from harl_tpu_torch.utils import spaces

# ----------------------------------------------------------- unit type table
# global type ids
MARINE, MARAUDER, MEDIVAC, STALKER, ZEALOT, COLOSSUS, HYDRALISK, ZERGLING, \
    BANELING, SPINECRAWLER = range(10)

TYPE_HEALTH = (45.0, 125.0, 150.0, 80.0, 100.0, 200.0, 80.0, 35.0, 30.0, 300.0)
TYPE_SHIELD = (0.0, 0.0, 0.0, 80.0, 50.0, 150.0, 0.0, 0.0, 0.0, 0.0)
TYPE_DAMAGE = (6.0, 10.0, 0.0, 13.0, 16.0, 20.0, 12.0, 5.0, 20.0, 25.0)
# weapon cooldown in game loops (unit_max_cooldown; medivac slot = max energy)
TYPE_COOLDOWN = (15.0, 25.0, 200.0, 35.0, 22.0, 24.0, 10.0, 11.0, 1.0, 27.0)
# weapon (or heal) range in world units; melee ≈ 1
TYPE_RANGE = (5.0, 6.0, 4.0, 6.0, 1.0, 7.0, 5.0, 1.0, 0.25, 7.0)
TYPE_SPEED = (3.15, 3.15, 3.5, 4.13, 3.15, 3.15, 3.15, 4.13, 4.13, 0.0)
# unit footprint radii (SC2 hitbox radii) for ground collision
TYPE_RADIUS = (0.375, 0.5625, 0.75, 0.625, 0.5, 1.0, 0.625, 0.375, 0.375, 0.75)
PROTOSS_TYPES = (STALKER, ZEALOT, COLOSSUS)

SHOOT_RANGE = 6.0          # unit_shoot_range: constant 6 for availability
SIGHT_RANGE = 9.0          # unit_sight_range
MOVE_AMOUNT = 2.0          # _move_amount
STEP_LOOPS = 8.0           # step_mul: game loops per env step
ARENA = 16.0               # half-size; map 32×32 like the SC2 micro maps
MAP_XY = 2 * ARENA
SPLASH_RADIUS = 2.2        # baneling acid splash
SHIELD_REGEN_DELAY = 18    # steps (~10 s) without damage before regen
SHIELD_REGEN = 2.0         # per step
HEAL_PER_STEP = 7.0        # medivac heal hp / step
HEAL_ENERGY_COST = 4.0     # energy / heal step
ENERGY_REGEN = 0.5         # medivac energy / step
REWARD_DEATH = 10.0        # reward_death_value
REWARD_WIN = 200.0         # reward_win
REWARD_SCALE_RATE = 20.0   # reward_scale_rate
MARINE_SPEED = 3.15        # chase steps are normalised to the marine's

N_MOVE_ACTIONS = 6         # no-op, stop, N, S, E, W
N_PATHING = 8              # n_obs_pathing (flat arena → constants)
N_HEIGHT = 9               # n_obs_height

_DIRS = ((0.0, 1.0), (0.0, -1.0), (1.0, 0.0), (-1.0, 0.0))

# SMACv2 race pools with the capability configs' weights; the name → id
# table follows the reference's unit_types strings (smaclite.py:198-239)
SMACV2_UNIT_IDS = {
    "marine": MARINE, "marauder": MARAUDER, "medivac": MEDIVAC,
    "stalker": STALKER, "zealot": ZEALOT, "colossus": COLOSSUS,
    "zergling": ZERGLING, "baneling": BANELING, "hydralisk": HYDRALISK,
}
SMACV2_POOLS = {
    "terran": ((MARINE, MARAUDER, MEDIVAC), (0.45, 0.45, 0.1)),
    "protoss": ((STALKER, ZEALOT, COLOSSUS), (0.45, 0.45, 0.1)),
    "zerg": ((ZERGLING, HYDRALISK, BANELING), (0.45, 0.45, 0.1)),
}
SMACV2_MAP_CONFIGS = (Path(__file__).resolve().parents[2] / "configs" / "envs_cfgs"
                      / "smacv2_map_config")


def load_smacv2_map_config(map_name: str) -> Optional[dict]:
    """A SMACv2 capability config by name from the port's copies of the
    per-map YAMLs: unit pool, weights, exception types, team sizes and the
    surrounded-spawn probability; None where no YAML has the name."""
    import yaml

    path = SMACV2_MAP_CONFIGS / f"{map_name}.yaml"
    if not path.exists():
        return None
    cfg = yaml.safe_load(path.read_text())
    # the YAMLs hold the whole wrapper's kwargs; only the capability
    # config is read
    cfg = cfg.get("capability_config", cfg)
    tg = cfg["team_gen"]
    sp = cfg.get("start_positions", {})
    return dict(
        n_units=int(cfg["n_units"]), n_enemies=int(cfg["n_enemies"]),
        pool=tuple(SMACV2_UNIT_IDS[u] for u in tg["unit_types"]),
        weights=tuple(float(w) for w in tg["weights"]),
        exception_types=tuple(SMACV2_UNIT_IDS[u] for u in tg.get("exception_unit_types", ())),
        surround_p=float(sp.get("p", 0.5)),
    )


def _recip(c: float) -> float:
    """float32 reciprocal of ``c``, exactly representable as a Python float."""
    return float(np.float32(1.0) / np.float32(c))


INV_SIGHT = _recip(SIGHT_RANGE)
INV_MARINE_SPEED = _recip(MARINE_SPEED)


# ------------------------------------------------------------- map registry
# name → (ally type ids, enemy type ids, episode limit, unit_type_bits)
def _reg():
    def m(n):  # n marines
        return (MARINE,) * n

    def sz(s, z):  # s stalkers + z zealots
        return (STALKER,) * s + (ZEALOT,) * z

    mmm = (MARINE,) * 7 + (MARAUDER,) * 2 + (MEDIVAC,)
    mmm2_e = (MARINE,) * 8 + (MARAUDER,) * 3 + (MEDIVAC,)
    bane = (ZERGLING,) * 20 + (BANELING,) * 4
    return {
        # marines
        "3m": (m(3), m(3), 60, 0),
        "8m": (m(8), m(8), 120, 0),
        "25m": (m(25), m(25), 150, 0),
        "5m_vs_5m": (m(5), m(5), 100, 0),
        "5m_vs_6m": (m(5), m(6), 70, 0),
        "8m_vs_9m": (m(8), m(9), 120, 0),
        "10m_vs_11m": (m(10), m(11), 150, 0),
        "27m_vs_30m": (m(27), m(30), 180, 0),
        "2m_vs_1z": (m(2), (ZEALOT,), 150, 0),
        # stalkers & zealots (unit_type_bits=2)
        "2s3z": (sz(2, 3), sz(2, 3), 120, 2),
        "3s5z": (sz(3, 5), sz(3, 5), 150, 2),
        "3s5z_vs_3s6z": (sz(3, 5), sz(3, 6), 170, 2),
        "3s6z_vs_3s6z": (sz(3, 6), sz(3, 6), 170, 2),
        "3s5z_vs_4s4z": (sz(3, 5), sz(4, 4), 150, 2),
        "4s4z_vs_4s4z": (sz(4, 4), sz(4, 4), 150, 2),
        "5s3z_vs_4s4z": (sz(5, 3), sz(4, 4), 150, 2),
        "6s2z_vs_4s4z": (sz(6, 2), sz(4, 4), 150, 2),
        "2s6z_vs_4s4z": (sz(2, 6), sz(4, 4), 150, 2),
        # stalkers vs zealots (homogeneous per side → bits 0)
        "3s_vs_3z": ((STALKER,) * 3, (ZEALOT,) * 3, 150, 0),
        "3s_vs_4z": ((STALKER,) * 3, (ZEALOT,) * 4, 200, 0),
        "3s_vs_5z": ((STALKER,) * 3, (ZEALOT,) * 5, 250, 0),
        "2s_vs_1sc": ((STALKER,) * 2, (SPINECRAWLER,), 300, 0),
        # colossi
        "1c3s5z": ((COLOSSUS,) + sz(3, 5), (COLOSSUS,) + sz(3, 5), 180, 3),
        "2c_vs_64zg": ((COLOSSUS,) * 2, (ZERGLING,) * 64, 400, 0),
        # MMM (unit_type_bits=3, medivac heal)
        "MMM": (mmm, mmm, 150, 3),
        "MMM2": (mmm, mmm2_e, 180, 3),
        # zerg
        "6h_vs_8z": ((HYDRALISK,) * 6, (ZEALOT,) * 8, 150, 0),
        "7h_vs_8z": ((HYDRALISK,) * 7, (ZEALOT,) * 8, 150, 0),
        "corridor": ((ZEALOT,) * 6, (ZERGLING,) * 24, 400, 0),
        "so_many_baneling": ((ZEALOT,) * 7, (BANELING,) * 32, 100, 0),
        "bane_vs_bane": (bane, bane, 200, 2),
    }


MAP_REGISTRY = _reg()


def _local_maps(ally_types, enemy_types, bits):
    """Global-id → local one-hot slot tables (get_unit_type_id,
    StarCraft2_Env.py:2157-2186): ally ids relative to the map's unit kinds,
    enemy ids in the fixed SC2 order."""
    def table(order):
        t = np.zeros(10, np.int64)
        for i, g in enumerate(order):
            t[g] = i
        return t

    kinds = set(ally_types) | set(enemy_types)
    if bits == 0:
        return table(()), table(())
    if kinds <= {STALKER, ZEALOT}:
        # ally: stalker=0, zealot=1; enemy: zealot(73)=0, stalker(74)=1
        return table((STALKER, ZEALOT)), table((ZEALOT, STALKER))
    if kinds <= {COLOSSUS, STALKER, ZEALOT}:
        o = (COLOSSUS, STALKER, ZEALOT)
        return table(o), table(o)
    if kinds <= {MARINE, MARAUDER, MEDIVAC}:
        o = (MARAUDER, MARINE, MEDIVAC)
        return table(o), table(o)
    if kinds <= {BANELING, ZERGLING}:
        o = (BANELING, ZERGLING)
        return table(o), table(o)
    o = tuple(sorted(kinds))
    return table(o), table(o)


class SMACLiteState(NamedTuple):
    ally_pos: torch.Tensor      # (X, A, 2)
    ally_health: torch.Tensor   # (X, A)
    ally_shield: torch.Tensor   # (X, A)
    ally_cd: torch.Tensor       # (X, A) weapon cooldown in loops (medivac: energy)
    ally_hit_t: torch.Tensor    # (X, A) steps since last damage taken
    enemy_pos: torch.Tensor     # (X, E, 2)
    enemy_health: torch.Tensor  # (X, E)
    enemy_shield: torch.Tensor
    enemy_cd: torch.Tensor
    enemy_hit_t: torch.Tensor
    ally_type: torch.Tensor     # (X, A) int64 global unit-type ids
    enemy_type: torch.Tensor    # (X, E) int64
    last_action: torch.Tensor   # (X, A) int32
    enemy_tgt: torch.Tensor     # (X, E) int64 acquired target (−1 none)
    t: torch.Tensor             # (X,) int32
    battle_over: torch.Tensor   # (X,) bool


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per env, rows ``idx`` of ``x``: x (X, U, …), idx (X, K) → (X, K, …)."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, *x.shape[2:]))


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """a·b + c rounded once, as XLA's CPU backend fuses a product into the
    sum that takes it (float64 holds the float32 product exactly)."""
    b = b.double() if isinstance(b, torch.Tensor) else float(np.float32(b))
    return (a.double() * b + c.double()).float()


def _norm(d: torch.Tensor) -> torch.Tensor:
    """Euclidean norm of (…, 2) vectors, rounded as XLA's CPU backend rounds
    ``jnp.linalg.norm``: x·x rounded, y·y fused into the add (formed in
    float64, rounded once), the square root correctly rounded (in float64,
    since torch's float32 ``sqrt`` on the CPU is not always). Every step is
    IEEE on both devices."""
    x, y = d[..., 0], d[..., 1].double()
    sq = torch.addcmul((x * x).double(), y, y).float()
    return sq.double().sqrt().float()


def _sum_over_units(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Σ_j w[…, j]·v[…, j, :] for w (X, U, U), v (X, U, U, 2), summed in the
    order XLA's CPU backend sums ``jnp.sum(w[..., None] * v, axis=1)``.

    Positions in a clump of overlapping units are sums of pushes that
    nearly cancel, so the order of the adds shows in the result far above
    float32 rounding. XLA sums up to 32 terms one after another with the
    product fused into each add (an FMA: one rounding per term, emulated
    here in float64); longer sums it splits into windows of 32 (padded
    evenly with zeros at both ends), each summed in order from its float32
    products, then adds the windows in order.
    """
    U = w.shape[-1]
    if U <= 32:
        w64, v64 = w.double(), v.double()
        acc = torch.zeros_like(v[..., 0, :])
        for j in range(U):
            acc = torch.addcmul(acc.double(), w64[..., j, None], v64[..., j, :]).float()
        return acc
    prod = w[..., None] * v
    n_win = -(-U // 32)
    pad = (n_win * 32 - U) // 2
    bounds = [0] + [min(U, max(0, k * 32 - pad)) for k in range(1, n_win)] + [U]
    total = torch.zeros_like(v[..., 0, :])
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        part = torch.zeros_like(total)
        for j in range(lo, hi):
            part = part + prod[..., j, :]
        total = total + part
    return total


def _f64_round(x: torch.Tensor, fn) -> torch.Tensor:
    """``fn`` of float32 ``x`` formed in float64, rounded once."""
    return fn(x.double()).float()


class SMACLite:
    """A SMACLite map over a batch of envs on ``device``: a fixed
    composition, or with ``randomize_types`` SMACv2's per-episode teams
    drawn from ``race_pool`` (the ally and enemy type tuples then only give
    the team sizes)."""

    metric_keys = ("won", "dead_allies", "dead_enemies")

    def __init__(self, ally_types: Tuple[int, ...], enemy_types: Tuple[int, ...],
                 episode_limit: int = 100, unit_type_bits: int = 0, state_type: str = "EP",
                 reward_scale: bool = True, device: torch.device = torch.device("cpu"),
                 randomize_types: bool = False, race_pool: Tuple[int, ...] = PROTOSS_TYPES,
                 race_weights: Tuple[float, ...] = (0.45, 0.45, 0.1),
                 exception_types: Tuple[int, ...] = (), surround_p: float = 0.5):
        if state_type not in ("EP", "FP"):
            raise ValueError(f"state_type {state_type!r}: EP or FP")
        self.ally_types = tuple(ally_types)
        self.enemy_types = tuple(enemy_types)
        self.episode_limit = episode_limit
        self.unit_type_bits = unit_type_bits
        self.state_type = state_type
        self.reward_scale = reward_scale
        self.device = torch.device(device)
        self.randomize_types = randomize_types
        self.race_pool = tuple(race_pool)
        self.race_weights = tuple(race_weights)
        self.exception_types = tuple(exception_types)
        self.surround_p = surround_p
        A, E = self.n_allies, self.n_enemies

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

        self.health, self.shield_max = f32(TYPE_HEALTH), f32(TYPE_SHIELD)
        self.damage, self.cooldown = f32(TYPE_DAMAGE), f32(TYPE_COOLDOWN)
        self.range, self.speed, self.radius = f32(TYPE_RANGE), f32(TYPE_SPEED), f32(TYPE_RADIUS)
        self.dirs = f32(_DIRS)
        kinds_a, kinds_e = self._kinds
        loc_a, loc_e = _local_maps(kinds_a, kinds_e, self._bits)
        self.loc_a = torch.as_tensor(loc_a, device=self.device)
        self.loc_e = torch.as_tensor(loc_e, device=self.device)
        self.ally_type0 = torch.as_tensor(self.ally_types, dtype=torch.int64, device=self.device)
        self.enemy_type0 = torch.as_tensor(self.enemy_types, dtype=torch.int64,
                                           device=self.device)
        # spawn lines (the JAX env's jnp.linspace, see the module docstring)
        self.spawn_a = f32(np.stack([np.full(A, -6.0), np.linspace(-A / 2, A / 2, A)], 1))
        self.spawn_e = f32(np.stack([np.full(E, 6.0), np.linspace(-E / 2, E / 2, E)], 1))
        self.eye_a = torch.eye(A, device=self.device)
        # _drop_diag: for viewer i the other allies j ≠ i, in order
        self.others = torch.as_tensor(
            [[j for j in range(A) if j != i] for i in range(A)], dtype=torch.int64,
            device=self.device).reshape(A, max(A - 1, 0))
        U = A + E
        idx = torch.arange(U, dtype=torch.float32, device=self.device)
        # antisymmetric nudge that separates coincident units, 1e-4·(i − j);
        # float64, so that adding it rounds once, as XLA's fused multiply-add
        self.nudge = float(np.float32(1e-4)) * (idx[:, None] - idx[None, :]).double()
        self.not_self = ~torch.eye(U, dtype=torch.bool, device=self.device)
        self.fallback_dir = f32((1.0, 0.0))
        self.inv_limit = _recip(episode_limit)
        self.inv_max_reward = _recip(self.max_reward)
        self.inv_n_allies = _recip(A)
        self.inv_n_enemies = _recip(E)
        # mechanics a map's unit kinds cannot trigger are skipped: with no
        # medivac or baneling on a side (in its race pool on a SMACv2 map),
        # its heal or splash terms are zeros
        self.ally_med, self.enemy_med = MEDIVAC in kinds_a, MEDIVAC in kinds_e
        self.ally_bane, self.enemy_bane = BANELING in kinds_a, BANELING in kinds_e
        if randomize_types:
            pool = np.asarray(self.race_pool)
            self.pool = torch.as_tensor(pool, dtype=torch.int64, device=self.device)
            # jax.random.choice's cumulative weights, float32
            self.pool_cum = torch.cumsum(f32(self.race_weights), 0)
            self.exc = torch.as_tensor(self.exception_types, dtype=torch.int64,
                                       device=self.device)
            w_ok = np.where(np.isin(pool, self.exception_types), 0.0, self.race_weights)
            self.fallback = int(pool[np.argmax(w_ok)])   # the heaviest non-exception type
            self.refl_lo = f32((-ARENA * 0.8, -ARENA * 0.5))
            self.refl_span = f32((-2.0, ARENA * 0.5)) - self.refl_lo

    # ------------------------------------------------------------- metadata
    @property
    def n_allies(self) -> int:
        return len(self.ally_types)

    @property
    def n_enemies(self) -> int:
        return len(self.enemy_types)

    @property
    def n_agents(self) -> int:
        return self.n_allies

    @property
    def n_actions(self) -> int:
        return N_MOVE_ACTIONS + self.n_enemies

    @property
    def reset_noise_dim(self) -> int:
        return 2 * (self.n_allies + self.n_enemies)

    @property
    def reset_noise_spec(self):
        """A fixed map: the spawn jitter's uniforms (the normal half is not
        read). A SMACv2 map: the draws of its reset (smaclite.py:404-453)."""
        if self.randomize_types:
            A, E = self.n_allies, self.n_enemies
            return (("uniform", A), ("uniform", E),                  # ally, enemy types
                    ("uniform", 1),                                  # the spawn branch
                    ("uniform", 2 * A), ("uniform", E), ("uniform", E),  # reflected: allies,
                    # the enemies' y and x jitter
                    ("normal", 2 * A),                               # surrounded allies
                    ("uniform", E), ("uniform", E))                  # the ring's angles, radii
        d = self.reset_noise_dim
        return (("uniform", d), ("normal", d))

    @property
    def _kinds(self) -> Tuple[tuple, tuple]:
        """The unit kinds each side can field: its types, or the race pool."""
        if self.randomize_types:
            return self.race_pool, self.race_pool
        return self.ally_types, self.enemy_types

    @property
    def shield_bits_ally(self) -> int:
        return 1 if set(self._kinds[0]) & set(PROTOSS_TYPES) else 0

    @property
    def shield_bits_enemy(self) -> int:
        return 1 if set(self._kinds[1]) & set(PROTOSS_TYPES) else 0

    @property
    def _bits(self) -> int:
        return 3 if self.randomize_types else self.unit_type_bits

    @property
    def obs_dim(self) -> int:
        A, nb = self.n_allies, self._bits
        nf_ally = 5 + self.shield_bits_ally + nb + self.n_actions
        nf_enemy = 5 + self.shield_bits_enemy + nb
        nf_own = 5 + self.shield_bits_ally + nb + self.n_actions
        return (A - 1) * nf_ally + self.n_enemies * nf_enemy + 4 + nf_own + A

    @property
    def state_dim(self) -> int:
        A, nb = self.n_allies, self._bits
        nf_ally = 4 + self.shield_bits_ally + nb + self.n_actions
        nf_enemy = 3 + self.shield_bits_enemy + nb
        mv = self.n_actions + N_PATHING + N_HEIGHT
        return A * nf_ally + self.n_enemies * nf_enemy + A * mv + 1

    @property
    def fp_state_dim(self) -> int:
        A, nb = self.n_allies, self._bits
        nf_ally = 6 + self.shield_bits_ally + 2 + nb + self.n_actions
        nf_enemy = 6 + self.shield_bits_enemy + nb + 2
        nf_own = 5 + self.shield_bits_ally + 2 + nb + self.n_actions
        return (A - 1) * nf_ally + self.n_enemies * nf_enemy + 4 + nf_own + A

    @property
    def observation_space(self):
        return [spaces.Box.create(-1.0, 1.0, self.obs_dim)] * self.n_allies

    @property
    def share_observation_space(self):
        d = self.fp_state_dim if self.state_type == "FP" else self.state_dim
        return [spaces.Box.create(-1.0, 1.0, d)] * self.n_allies

    @property
    def action_space(self):
        return [spaces.Discrete(self.n_actions) for _ in range(self.n_allies)]

    @property
    def max_reward(self) -> float:
        # n_enemies·death + win + Σ enemy (health + shield) at full
        et = np.asarray(self.enemy_types)
        hp = float(np.asarray(TYPE_HEALTH)[et].sum() + np.asarray(TYPE_SHIELD)[et].sum())
        if self.randomize_types:   # an upper bound: the beefiest pool unit
            pool = np.asarray(self.race_pool)
            hp = float(self.n_enemies * (np.asarray(TYPE_HEALTH)[pool]
                                         + np.asarray(TYPE_SHIELD)[pool]).max())
        return self.n_enemies * REWARD_DEATH + REWARD_WIN + hp

    # -------------------------------------------------------------- dynamics
    def reset(self, noise: Tuple[torch.Tensor, ...]) -> Tuple[SMACLiteState, TimeStep]:
        """``noise`` as ``reset_noise_spec`` asks. A fixed map: (uniform
        [0, 1), normal), each (X, 2A+2E); the uniform part is the spawn
        jitter of the allies (first 2A) and the enemies (smaclite.py:454-462),
        mapped to U(−1, 1) as ``jax.random.uniform`` maps it. A SMACv2 map:
        its teams and spawns (``_randomized``)."""
        X, A, E = noise[0].shape[0], self.n_allies, self.n_enemies
        dev = self.device
        if self.randomize_types:
            ally_type, enemy_type, ally_pos, enemy_pos = self._randomized(noise)
        else:
            jitter = torch.clamp(noise[0] * 2.0 + (-1.0), min=-1.0)
            ally_pos = self.spawn_a + jitter[:, : 2 * A].reshape(X, A, 2)
            enemy_pos = self.spawn_e + jitter[:, 2 * A:].reshape(X, E, 2)
            ally_type = self.ally_type0.expand(X, A).contiguous()
            enemy_type = self.enemy_type0.expand(X, E).contiguous()
        state = SMACLiteState(
            ally_pos=ally_pos,
            ally_health=self.health[ally_type],
            ally_shield=self.shield_max[ally_type],
            # medivacs start with full energy in the cd slot
            ally_cd=torch.where(ally_type == MEDIVAC, self.cooldown[ally_type], 0.0),
            ally_hit_t=torch.full((X, A), 100.0, device=dev),
            enemy_pos=enemy_pos,
            enemy_health=self.health[enemy_type],
            enemy_shield=self.shield_max[enemy_type],
            enemy_cd=torch.where(enemy_type == MEDIVAC, self.cooldown[enemy_type], 0.0),
            enemy_hit_t=torch.full((X, E), 100.0, device=dev),
            ally_type=ally_type,
            enemy_type=enemy_type,
            last_action=torch.zeros((X, A), dtype=torch.int32, device=dev),
            enemy_tgt=torch.full((X, E), -1, dtype=torch.int64, device=dev),
            t=torch.zeros(X, dtype=torch.int32, device=dev),
            battle_over=torch.zeros(X, dtype=torch.bool, device=dev),
        )
        no = torch.zeros(X, dtype=torch.bool, device=dev)
        return state, self._timestep(state, torch.zeros(X, device=dev), no, no, no)

    def _randomized(self, noise: Tuple[torch.Tensor, ...]):
        """SMACv2's teams and spawns (smaclite.py:408-451) from the draws of
        ``reset_noise_spec``: (ally types, enemy types, ally positions, enemy
        positions)."""
        u_a, u_e, coin, u_refl, u_ey, u_ex, n_sur, u_ang, u_rad = noise
        X, A, E = u_a.shape[0], self.n_allies, self.n_enemies

        def team(u):
            # jax.random.choice(k, len(pool), shape, p=w), replace=True
            r = self.pool_cum[-1] * (1.0 - u)
            t = self.pool[torch.searchsorted(self.pool_cum, r.contiguous(), right=False)]
            if self.exception_types:
                # a team of exception types only: unit 0 becomes the
                # heaviest other type
                only = torch.isin(t, self.exc).all(dim=1)
                t = torch.cat([torch.where(only, self.fallback, t[:, 0])[:, None], t[:, 1:]], 1)
            return t

        def uniform(u, lo, span):
            return torch.clamp(_fma(u, span, torch.full_like(u, lo)), min=lo)

        surround = (coin[:, 0] < self.surround_p)[:, None, None]
        ally_refl = torch.maximum(_fma(u_refl.reshape(X, A, 2), self.refl_span,
                                       self.refl_lo.expand(X, A, 2)), self.refl_lo)
        ey = uniform(u_ey, -ARENA * 0.5, ARENA)
        # the allies' mean x as XLA forms it: summed in order, times 1/A
        sum_x = ally_refl[:, 0, 0]
        for k in range(1, A):
            sum_x = sum_x + ally_refl[:, k, 0]
        ex = -(sum_x * _recip(A))[:, None] + uniform(u_ex, -2.0, 4.0)
        ally_sur = 2.0 * n_sur.reshape(X, A, 2)
        ang = uniform(u_ang, 0.0, 2.0 * math.pi)
        radius = uniform(u_rad, 8.0, 3.0)
        enemy_sur = torch.stack([radius * _f64_round(ang, torch.cos),
                                 radius * _f64_round(ang, torch.sin)], dim=-1)
        ally_pos = torch.where(surround, ally_sur, ally_refl)
        enemy_pos = torch.where(surround, enemy_sur, torch.stack([ex, ey], dim=-1))
        return team(u_a), team(u_e), ally_pos, enemy_pos

    def _attack_phase(self, att_pos, att_type, att_alive, att_cd, want_attack,
                      tgt, tgt_pos, tgt_alive, n_tgt, has_bane: bool):
        """One side's attacks: chase or fire per attacker (smaclite.py:487-519).
        Returns (damage (X, n_tgt), baneling-fired mask, new positions, new
        cooldowns)."""
        to_t = _take(tgt_pos, tgt) - att_pos
        dist = _norm(to_t)
        w_range = self.range[att_type]
        t_alive = _take(tgt_alive, tgt)
        can_fire = want_attack & att_alive & t_alive & (att_cd <= 0.0)
        in_range = dist <= w_range
        fires = can_fire & in_range
        chases = want_attack & att_alive & t_alive & ~in_range
        # chase at unit speed (normalised to the marine's MOVE_AMOUNT step)
        nrm = torch.clamp(dist, min=1e-6)[..., None]     # |to_t|, as in the JAX env
        step_len = torch.minimum(
            MOVE_AMOUNT * self.speed[att_type] * INV_MARINE_SPEED,
            torch.clamp(_fma(w_range, -0.8, dist), min=0.0))
        new_pos = torch.where(chases[..., None], _fma(to_t / nrm, step_len[..., None], att_pos),
                              att_pos)
        is_bane = att_type == BANELING
        dmg_per = self.damage[att_type]
        point_dmg = torch.where(fires & ~is_bane, dmg_per, 0.0)
        # damage values are small integers, so the sum is exact in any order
        # (also under the unordered atomics of scatter_add_ on CUDA)
        dmg = torch.zeros(att_pos.shape[0], n_tgt, device=self.device).scatter_add_(
            1, tgt, point_dmg)
        # baneling suicide splash: AoE around the exploding unit
        bane_fire = fires & is_bane
        if has_bane:
            d_bt = _norm(tgt_pos[:, None, :, :] - att_pos[:, :, None, :])  # (X, att, tgt)
            splash = (d_bt <= SPLASH_RADIUS) & bane_fire[..., None] & tgt_alive[:, None, :]
            dmg = dmg + torch.where(splash, dmg_per[..., None], 0.0).sum(dim=1)
        new_cd = torch.where(fires, self.cooldown[att_type], att_cd)
        return dmg, bane_fire, new_pos, new_cd

    def _resolve_collisions(self, ally_pos, enemy_pos, a_solid, e_solid, ally_type,
                            enemy_type):
        """One pass of pairwise footprint separation (smaclite.py:521-555)."""
        pos = torch.cat([ally_pos, enemy_pos], dim=1)                       # (X, U, 2)
        solid = torch.cat([a_solid, e_solid], dim=1)                        # (X, U)
        rad = self.radius[torch.cat([ally_type, enemy_type], dim=1)]
        delta = pos[:, :, None, :] - pos[:, None, :, :]                     # (X, U, U, 2)
        delta = torch.stack([(delta[..., 0].double() + self.nudge).float(), delta[..., 1]], dim=-1)
        dist = _norm(delta)
        pair = solid[:, :, None] & solid[:, None, :] & self.not_self
        overlap = torch.clamp(rad[:, :, None] + rad[:, None, :] - dist, min=0.0)
        overlap = torch.where(pair, overlap, 0.0)
        safe = torch.clamp(dist, min=1e-6)[..., None]
        dirn = torch.where(dist[..., None] > 1e-6, delta / safe, self.fallback_dir)
        push = 0.5 * _sum_over_units(overlap, dirn)
        # clamp: a unit cannot be shoved further than one move step
        pn = torch.clamp(_norm(push), min=1e-9)[..., None]
        moved = _fma(push / pn, torch.clamp(pn, max=MOVE_AMOUNT), pos)
        new = torch.clamp(torch.where(solid[..., None], moved, pos), -ARENA, ARENA)
        A = ally_pos.shape[1]
        return new[:, :A], new[:, A:]

    def step(self, state: SMACLiteState, actions: torch.Tensor) -> Tuple[SMACLiteState, TimeStep]:
        """actions (X, A, 1) integer (smaclite.py:557-751)."""
        a = actions[..., 0].to(torch.int32)
        al = a.long()
        A, E = self.n_allies, self.n_enemies
        ally_alive = state.ally_health > 0
        enemy_alive = state.enemy_health > 0
        is_med_a = state.ally_type == MEDIVAC
        is_med_e = state.enemy_type == MEDIVAC

        # --- ally movement --------------------------------------------------
        is_move = (a >= 2) & (a < 6) & ally_alive
        direction = self.dirs[torch.clamp(al - 2, 0, 3)]
        ally_pos = torch.clamp(
            state.ally_pos + torch.where(is_move[..., None], direction * MOVE_AMOUNT, 0.0),
            -ARENA, ARENA)

        # --- ally attacks (non-medivac) -------------------------------------
        tgt = torch.clamp(al - N_MOVE_ACTIONS, 0, E - 1)
        want_attack = (a >= N_MOVE_ACTIONS) & ~is_med_a
        dmg_to_enemy, bane_a, ally_pos, ally_cd = self._attack_phase(
            ally_pos, state.ally_type, ally_alive, state.ally_cd, want_attack, tgt,
            state.enemy_pos, enemy_alive, E, self.ally_bane)

        # --- ally medivac heal ----------------------------------------------
        heal_range = TYPE_RANGE[MEDIVAC]
        if self.ally_med:
            heal_tgt = torch.clamp(al - N_MOVE_ACTIONS, 0, A - 1)
            to_h = _take(ally_pos, heal_tgt) - ally_pos
            hdist = _norm(to_h)
            damaged = state.ally_health < self.health[state.ally_type]
            t_alive = _take(ally_alive, heal_tgt)
            heals = ((a >= N_MOVE_ACTIONS) & is_med_a & ally_alive & t_alive
                     & _take(damaged, heal_tgt) & (hdist <= heal_range)
                     & (state.ally_cd >= HEAL_ENERGY_COST))
            # heals are 7 hp each: exact in any order of the adds
            heal_in = torch.zeros_like(state.ally_health).scatter_add_(
                1, heal_tgt, torch.where(heals, HEAL_PER_STEP, 0.0))
            # medivac chases its heal target when out of range
            med_chases = ((a >= N_MOVE_ACTIONS) & is_med_a & ally_alive & t_alive
                          & (hdist > heal_range))
            nrm_h = torch.clamp(hdist, min=1e-6)[..., None]
            ally_pos = ally_pos + torch.where(med_chases[..., None],
                                              to_h / nrm_h * MOVE_AMOUNT, 0.0)

        # --- enemy AI: per-unit acquisition with pursuit persistence --------
        # (smaclite.py:599-647: keep the lock while alive, in sight and, when
        # being hit, in weapon range; else closest in weapon range, else
        # closest in sight, else advance on the closest ally)
        dist_ea = _norm(state.enemy_pos[:, :, None, :] - ally_pos[:, None, :, :])  # (X, E, A)
        in_sight = dist_ea <= SIGHT_RANGE
        in_wr = dist_ea <= self.range[state.enemy_type][..., None]
        cur = torch.clamp(state.enemy_tgt, 0, A - 1)
        cur_in_wr = torch.gather(in_wr, 2, cur[..., None])[..., 0]
        hit_now = dmg_to_enemy > 0.0
        cur_ok = ((state.enemy_tgt >= 0) & _take(ally_alive, cur)
                  & torch.gather(in_sight, 2, cur[..., None])[..., 0]
                  & (cur_in_wr | ~hit_now))
        alive_ea = ally_alive[:, None, :]
        d_wr = torch.where(alive_ea & in_wr, dist_ea, 1e9)
        d_sight = torch.where(alive_ea & in_sight, dist_ea, 1e9)
        d_any = torch.where(alive_ea, dist_ea, 1e9)
        # argmin takes the first of equal distances, as jnp.argmin does
        e_tgt = torch.where(
            cur_ok, cur,
            torch.where(d_wr.amin(dim=2) < 1e9, d_wr.argmin(dim=2),
                        torch.where(d_sight.amin(dim=2) < 1e9, d_sight.argmin(dim=2),
                                    d_any.argmin(dim=2))))
        e_want = enemy_alive & ~is_med_e & ally_alive.any(dim=1, keepdim=True)
        dmg_to_ally, bane_e, enemy_pos, enemy_cd = self._attack_phase(
            state.enemy_pos, state.enemy_type, enemy_alive, state.enemy_cd, e_want, e_tgt,
            ally_pos, ally_alive, A, self.enemy_bane)
        if self.enemy_med:
            # enemy medivac: heal the most-damaged living non-medivac enemy
            e_deficit = torch.where(enemy_alive & ~is_med_e,
                                    self.health[state.enemy_type] - state.enemy_health, -1.0)
            e_heal_tgt = e_deficit.argmax(dim=1, keepdim=True)             # (X, 1)
            needs = _take(e_deficit, e_heal_tgt) > 0                        # (X, 1)
            to_eh = _take(enemy_pos, e_heal_tgt) - enemy_pos
            ehdist = _norm(to_eh)
            e_heals = (is_med_e & enemy_alive & needs & (ehdist <= heal_range)
                       & (enemy_cd >= HEAL_ENERGY_COST))
            e_heal_in = torch.zeros_like(state.enemy_health).scatter_add_(
                1, e_heal_tgt,
                torch.where(e_heals, HEAL_PER_STEP, 0.0).sum(dim=1, keepdim=True))
            e_med_chase = is_med_e & enemy_alive & needs & (ehdist > heal_range)
            nrm_eh = torch.clamp(ehdist, min=1e-6)[..., None]
            enemy_pos = enemy_pos + torch.where(e_med_chase[..., None],
                                                to_eh / nrm_eh * MOVE_AMOUNT, 0.0)

        # --- apply damage: shields first, then health (Protoss mechanics) ---
        def absorb(shield, health, dmg, alive):
            dmg = torch.where(alive, dmg, 0.0)
            sh_after = torch.clamp(shield - dmg, min=0.0)
            spill = torch.clamp(dmg - shield, min=0.0)
            return sh_after, torch.clamp(health - spill, min=0.0), dmg > 0

        e_shield, e_health, e_hit = absorb(state.enemy_shield, state.enemy_health,
                                           dmg_to_enemy, enemy_alive)
        a_shield, a_health, a_hit = absorb(state.ally_shield, state.ally_health,
                                           dmg_to_ally, ally_alive)
        # banelings die on exploding
        a_health = torch.where(bane_a, 0.0, a_health)
        e_health = torch.where(bane_e, 0.0, e_health)
        # heals (cannot exceed max health) and cooldown / energy bookkeeping
        max_energy = TYPE_COOLDOWN[MEDIVAC]
        ally_cd = torch.clamp(ally_cd - STEP_LOOPS, min=0.0)
        if self.ally_med:
            a_health = torch.where(
                ally_alive & (a_health > 0),
                torch.minimum(a_health + heal_in, self.health[state.ally_type]), a_health)
            ally_cd = torch.where(
                is_med_a,
                torch.clamp(state.ally_cd + ENERGY_REGEN
                            - torch.where(heals, HEAL_ENERGY_COST, 0.0), 0.0, max_energy),
                ally_cd)
        enemy_cd = torch.clamp(enemy_cd - STEP_LOOPS, min=0.0)
        if self.enemy_med:
            e_health = torch.where(
                enemy_alive & (e_health > 0),
                torch.minimum(e_health + e_heal_in, self.health[state.enemy_type]), e_health)
            enemy_cd = torch.where(
                is_med_e,
                torch.clamp(state.enemy_cd + ENERGY_REGEN
                            - torch.where(e_heals, HEAL_ENERGY_COST, 0.0), 0.0, max_energy),
                enemy_cd)

        # --- shield regeneration --------------------------------------------
        a_hit_t = torch.where(a_hit, 0.0, state.ally_hit_t + 1.0)
        e_hit_t = torch.where(e_hit, 0.0, state.enemy_hit_t + 1.0)
        a_shield = torch.where(
            (a_hit_t >= SHIELD_REGEN_DELAY) & (a_health > 0),
            torch.minimum(a_shield + SHIELD_REGEN, self.shield_max[state.ally_type]), a_shield)
        e_shield = torch.where(
            (e_hit_t >= SHIELD_REGEN_DELAY) & (e_health > 0),
            torch.minimum(e_shield + SHIELD_REGEN, self.shield_max[state.enemy_type]), e_shield)

        # --- reward (reward_battle, reward_only_positive=True) --------------
        prev_e_total = state.enemy_health + state.enemy_shield
        new_e_total = e_health + e_shield
        delta_enemy = torch.where(
            enemy_alive, torch.clamp(prev_e_total - new_e_total, min=0.0), 0.0).sum(dim=1)
        kills = (enemy_alive & (e_health <= 0)).sum(dim=1)
        won = (e_health <= 0).all(dim=1)
        all_allies_dead = (a_health <= 0).all(dim=1)
        reward = delta_enemy + kills * REWARD_DEATH + torch.where(won, REWARD_WIN, 0.0)
        if self.reward_scale:
            reward = reward * self.inv_max_reward * REWARD_SCALE_RATE

        new_t = state.t + 1
        time_up = new_t >= self.episode_limit
        terminated = won | all_allies_dead
        done = terminated | time_up
        bad_transition = time_up & ~terminated

        # --- ground-unit collision: soft push-out of overlapping footprints
        ally_pos, enemy_pos = self._resolve_collisions(
            ally_pos, enemy_pos, (a_health > 0) & ~is_med_a, (e_health > 0) & ~is_med_e,
            state.ally_type, state.enemy_type)

        new_state = SMACLiteState(
            ally_pos=ally_pos, ally_health=a_health, ally_shield=a_shield,
            ally_cd=ally_cd, ally_hit_t=a_hit_t,
            enemy_pos=enemy_pos, enemy_health=e_health, enemy_shield=e_shield,
            enemy_cd=enemy_cd, enemy_hit_t=e_hit_t,
            ally_type=state.ally_type, enemy_type=state.enemy_type,
            last_action=a, enemy_tgt=e_tgt, t=new_t, battle_over=done,
        )
        return new_state, self._timestep(new_state, reward, done, bad_transition, won)

    # -------------------------------------------------------- feature blocks
    def _type_onehot(self, types: torch.Tensor,
                     local_table: torch.Tensor) -> Optional[torch.Tensor]:
        if self._bits == 0:
            return None
        return F.one_hot(local_table[types], self._bits).to(torch.float32)

    def _can_move(self, pos: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
        """(X, N, 4) can-move bits: bounds check per direction (can_move)."""
        nxt = pos[:, :, None, :] + self.dirs * (MOVE_AMOUNT / 2)
        ok = ((nxt >= -ARENA) & (nxt <= ARENA)).all(dim=-1)
        return ok & alive[..., None]

    def _shield_frac(self, shield: torch.Tensor, types: torch.Tensor) -> torch.Tensor:
        return shield / torch.clamp(self.shield_max[types], min=1.0)

    def _drop_diag(self, af: torch.Tensor) -> torch.Tensor:
        """(X, A, A, F) → (X, A, (A−1)·F) without each viewer's own row."""
        X, A = af.shape[:2]
        rows = torch.arange(A, device=self.device)[:, None]
        return af[:, rows, self.others].reshape(X, A, -1)

    def _features(self, state: SMACLiteState) -> "_Feats":
        """What the feature blocks of one timestep share, computed once. The
        JAX env computes some of it up to three times; the values are the
        same (a norm of −v rounds as the norm of v)."""
        pos = state.ally_pos
        ally_alive = state.ally_health > 0
        delta_e = state.enemy_pos[:, None] - pos[:, :, None]
        delta_a = pos[:, None] - pos[:, :, None]
        return _Feats(
            ally_alive=ally_alive, enemy_alive=state.enemy_health > 0,
            a_hp=state.ally_health / self.health[state.ally_type],
            e_hp=state.enemy_health / self.health[state.enemy_type],
            a_sh=(self._shield_frac(state.ally_shield, state.ally_type)
                  if self.shield_bits_ally else None),
            e_sh=(self._shield_frac(state.enemy_shield, state.enemy_type)
                  if self.shield_bits_enemy else None),
            a_cd=state.ally_cd / self.cooldown[state.ally_type],
            cxy_a=pos / (MAP_XY / 2), cxy_e=state.enemy_pos / (MAP_XY / 2),
            delta_e=delta_e, dist_e=_norm(delta_e), delta_a=delta_a, dist_a=_norm(delta_a),
            move=self._can_move(pos, ally_alive).to(torch.float32),
            last_a=F.one_hot(state.last_action.long(), self.n_actions).to(torch.float32),
            a_oh=self._type_onehot(state.ally_type, self.loc_a),
            e_oh=self._type_onehot(state.enemy_type, self.loc_e))

    def _obs(self, f: "_Feats", avail: torch.Tensor) -> torch.Tensor:
        """get_obs_agent layout: ally | enemy | move | own | agent_id
        (smaclite.py:765-842)."""
        X, A, E = f.a_hp.shape[0], self.n_allies, self.n_enemies

        # enemy features (X, A, E, nf)
        vis_e = (f.dist_e < SIGHT_RANGE) & f.enemy_alive[:, None, :] & f.ally_alive[:, :, None]
        ef = [avail[..., N_MOVE_ACTIONS:], f.dist_e * INV_SIGHT, f.delta_e[..., 0] * INV_SIGHT,
              f.delta_e[..., 1] * INV_SIGHT, f.e_hp[:, None, :].expand(X, A, E)]
        if f.e_sh is not None:
            ef.append(f.e_sh[:, None, :].expand(X, A, E))
        ef = torch.stack(ef, dim=-1)
        if f.e_oh is not None:
            ef = torch.cat([ef, f.e_oh[:, None].expand(X, A, E, self._bits)], dim=-1)
        ef = torch.where(vis_e[..., None], ef, 0.0).reshape(X, A, -1)

        # ally features (X, A, A, nf), then drop the viewer's own row
        vis_a = (f.dist_a < SIGHT_RANGE) & f.ally_alive[:, None, :] & f.ally_alive[:, :, None]
        af = [vis_a.to(torch.float32), f.dist_a * INV_SIGHT, f.delta_a[..., 0] * INV_SIGHT,
              f.delta_a[..., 1] * INV_SIGHT, f.a_hp[:, None, :].expand(X, A, A)]
        if f.a_sh is not None:
            af.append(f.a_sh[:, None, :].expand(X, A, A))
        extra = [f.last_a[:, None].expand(X, A, A, self.n_actions)]
        if f.a_oh is not None:
            extra.insert(0, f.a_oh[:, None].expand(X, A, A, self._bits))
        af = torch.cat([torch.stack(af, dim=-1)] + extra, dim=-1)
        # whole row gated on sight, the ally alive and the viewer alive
        af = self._drop_diag(af * vis_a[..., None].to(torch.float32))

        own = [torch.ones((X, A, 1), device=self.device),
               torch.zeros((X, A, 3), device=self.device), f.a_hp[..., None]]
        if f.a_sh is not None:
            own.append(f.a_sh[..., None])
        if f.a_oh is not None:
            own.append(f.a_oh)
        own.append(f.last_a)
        own = torch.cat(own, dim=-1) * f.ally_alive[..., None]
        ids = self.eye_a.expand(X, A, A)
        # the move bits are already gated on the viewer being alive
        return torch.cat([af, ef, f.move, own, ids], dim=-1)

    def _state(self, state: SMACLiteState, f: "_Feats", avail: torch.Tensor) -> torch.Tensor:
        """get_global_state (EP): ally | enemy | move | timestep
        (smaclite.py:844-886)."""
        X, A = f.a_hp.shape[0], self.n_allies
        ally = [f.a_hp[..., None], f.a_cd[..., None], f.cxy_a]
        if f.a_sh is not None:
            ally.append(f.a_sh[..., None])
        if f.a_oh is not None:
            ally.append(f.a_oh)
        ally.append(f.last_a)
        ally = torch.cat(ally, dim=-1) * f.ally_alive[..., None]

        enemy = [f.e_hp[..., None], f.cxy_e]
        if f.e_sh is not None:
            enemy.append(f.e_sh[..., None])
        if f.e_oh is not None:
            enemy.append(f.e_oh)
        enemy = torch.cat(enemy, dim=-1) * f.enemy_alive[..., None]

        # per-agent move state: full avail actions + flat-arena pathing (1s)
        # + height (0s), constant on a flat map
        move = torch.cat([avail, torch.ones((X, A, N_PATHING), device=self.device),
                          torch.zeros((X, A, N_HEIGHT), device=self.device)], dim=-1)
        ts_num = (state.t.to(torch.float32) * self.inv_limit)[:, None]
        return torch.cat([ally.reshape(X, -1), enemy.reshape(X, -1), move.reshape(X, -1),
                          ts_num], dim=-1)

    def _agent_state(self, f: "_Feats", avail: torch.Tensor) -> torch.Tensor:
        """get_state_agent (FP): per agent ally | enemy | move | own | id
        (smaclite.py:888-975)."""
        X, A, E = f.a_hp.shape[0], self.n_allies, self.n_enemies
        geo = f.ally_alive[:, :, None, None].to(torch.float32)              # viewer alive

        # ally rows (viewer i, ally j)
        af = [(f.dist_a < SIGHT_RANGE).to(torch.float32)[..., None] * geo,
              (f.dist_a * INV_SIGHT)[..., None] * geo, (f.delta_a * INV_SIGHT) * geo,
              f.a_cd[:, None, :, None].expand(X, A, A, 1),
              f.a_hp[:, None, :, None].expand(X, A, A, 1)]
        if f.a_sh is not None:
            af.append(f.a_sh[:, None, :, None].expand(X, A, A, 1))
        af.append(f.cxy_a[:, None].expand(X, A, A, 2))
        if f.a_oh is not None:
            af.append(f.a_oh[:, None].expand(X, A, A, self._bits))
        af.append(f.last_a[:, None].expand(X, A, A, self.n_actions))
        af = self._drop_diag(torch.cat(af, dim=-1) * f.ally_alive[:, None, :, None])

        # enemy rows (viewer i, enemy j)
        ef = [avail[..., N_MOVE_ACTIONS:, None] * geo, (f.dist_e * INV_SIGHT)[..., None] * geo,
              (f.delta_e * INV_SIGHT) * geo,
              (f.dist_e < SIGHT_RANGE).to(torch.float32)[..., None] * geo,
              f.e_hp[:, None, :, None].expand(X, A, E, 1)]
        if f.e_sh is not None:
            ef.append(f.e_sh[:, None, :, None].expand(X, A, E, 1))
        if f.e_oh is not None:
            ef.append(f.e_oh[:, None].expand(X, A, E, self._bits))
        ef.append(f.cxy_e[:, None].expand(X, A, E, 2))
        ef = (torch.cat(ef, dim=-1) * f.enemy_alive[:, None, :, None]).reshape(X, A, -1)

        own = [torch.ones((X, A, 1), device=self.device),
               torch.zeros((X, A, 3), device=self.device), f.a_hp[..., None]]
        if f.a_sh is not None:
            own.append(f.a_sh[..., None])
        own.append(f.cxy_a)
        if f.a_oh is not None:
            own.append(f.a_oh)
        own.append(f.last_a)
        # use_mustalive: all but the agent id zero when the viewer is dead
        gate = f.ally_alive[..., None].to(torch.float32)
        body = torch.cat([af, ef, f.move, torch.cat(own, dim=-1)], dim=-1) * gate
        return torch.cat([body, self.eye_a.expand(X, A, A)], dim=-1)

    def _avail(self, state: SMACLiteState, f: "_Feats") -> torch.Tensor:
        """get_avail_agent_actions (smaclite.py:977-1005)."""
        A, E = self.n_allies, self.n_enemies
        alive = f.ally_alive
        is_med = state.ally_type == MEDIVAC
        attack_avail = ((f.dist_e <= SHOOT_RANGE) & f.enemy_alive[:, None, :]
                        & alive[..., None] & ~is_med[..., None])
        target_avail = attack_avail.to(torch.float32)
        if self.ally_med:
            # medivac heal targets: living non-medivac allies within shoot
            # range, in the first min(A, E) target slots
            heal_ok = ((f.dist_a <= SHOOT_RANGE) & alive[:, None, :] & alive[..., None]
                       & is_med[..., None] & ~is_med[:, None, :] & (self.eye_a == 0))
            k = min(A, E)
            head = torch.where(is_med[..., None], heal_ok[..., :k].to(torch.float32),
                               target_avail[..., :k])
            target_avail = torch.cat([head, target_avail[..., k:]], dim=-1)
        noop = (~alive).to(torch.float32)[..., None]
        stop = alive.to(torch.float32)[..., None]
        return torch.cat([noop, stop, f.move, target_avail], dim=-1)

    def _timestep(self, state: SMACLiteState, reward, done, bad_transition, won) -> TimeStep:
        X, A = state.ally_pos.shape[0], self.n_allies
        dead = state.ally_health <= 0
        f = self._features(state)
        avail = self._avail(state, f)
        return TimeStep(
            obs=self._obs(f, avail),
            share_obs=self._state(state, f, avail),
            rewards=reward.to(torch.float32)[:, None, None].expand(X, A, 1),
            dones=done[:, None] | dead,       # StarCraft2_Env.py:571-577
            bad_transition=bad_transition,
            available_actions=avail,
            agent_state=self._agent_state(f, avail) if self.state_type == "FP" else None,
            metrics={
                "won": won.to(torch.float32),
                "dead_allies": dead.to(torch.float32).sum(dim=1) * self.inv_n_allies,
                "dead_enemies": (~f.enemy_alive).to(torch.float32).sum(dim=1)
                * self.inv_n_enemies,
            },
        )


class _Feats(NamedTuple):
    """Per-timestep quantities the feature blocks share (``_features``)."""

    ally_alive: torch.Tensor              # (X, A) bool
    enemy_alive: torch.Tensor             # (X, E) bool
    a_hp: torch.Tensor                    # (X, A) health fraction
    e_hp: torch.Tensor                    # (X, E)
    a_sh: Optional[torch.Tensor]          # (X, A) shield fraction (Protoss maps)
    e_sh: Optional[torch.Tensor]          # (X, E)
    a_cd: torch.Tensor                    # (X, A) cooldown (medivac: energy) fraction
    cxy_a: torch.Tensor                   # (X, A, 2) positions / half the map
    cxy_e: torch.Tensor                   # (X, E, 2)
    delta_e: torch.Tensor                 # (X, A, E, 2) enemy j − ally i
    dist_e: torch.Tensor                  # (X, A, E)
    delta_a: torch.Tensor                 # (X, A, A, 2) ally j − ally i
    dist_a: torch.Tensor                  # (X, A, A)
    move: torch.Tensor                    # (X, A, 4) can-move bits, 0 where dead
    last_a: torch.Tensor                  # (X, A, n_actions) one-hot last action
    a_oh: Optional[torch.Tensor]          # (X, A, bits) unit-type one-hot
    e_oh: Optional[torch.Tensor]          # (X, E, bits)


def make_smaclite(map_name: str = "5m_vs_5m", device: torch.device = torch.device("cpu"),
                  episode_limit: Optional[int] = None, state_type: str = "EP",
                  reward_scale: bool = True) -> SMACLite:
    """A SMACv2 capability config by name, a SMACv2 name of the form
    ``<race>_<A>_vs_<E>`` (the race's pool and weights), a map from the
    registry (smac_maps.py parity) or the generic ``Nm_vs_Mm`` marine
    pattern (smaclite.py:1043-1088)."""
    kw = dict(state_type=state_type, reward_scale=reward_scale, device=device)
    v2 = load_smacv2_map_config(map_name)
    if v2 is not None:
        return SMACLite((v2["pool"][0],) * v2["n_units"], (v2["pool"][0],) * v2["n_enemies"],
                        episode_limit or 150, randomize_types=True, race_pool=v2["pool"],
                        race_weights=v2["weights"], exception_types=v2["exception_types"],
                        surround_p=v2["surround_p"], **kw)
    for race, (pool, weights) in SMACV2_POOLS.items():
        if map_name.startswith(race):
            parts = map_name.split("_")
            n_allies = int(parts[1])
            n_enemies = int(parts[3]) if len(parts) > 3 else n_allies
            return SMACLite((pool[0],) * n_allies, (pool[0],) * n_enemies, episode_limit or 150,
                            randomize_types=True, race_pool=pool, race_weights=weights, **kw)
    if map_name in MAP_REGISTRY:
        ally, enemy, limit, bits = MAP_REGISTRY[map_name]
        return SMACLite(ally, enemy, episode_limit or limit, bits, **kw)
    # generic marine pattern fallback: '7m', '12m_vs_13m'
    name = map_name.replace("m", "").split("_vs_")
    n_allies = int(name[0])
    n_enemies = int(name[1]) if len(name) == 2 else n_allies
    return SMACLite((MARINE,) * n_allies, (MARINE,) * n_enemies, episode_limit or 100, 0,
                    **kw)
