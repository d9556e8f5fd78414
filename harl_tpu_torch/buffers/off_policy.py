"""Device-resident off-policy replay buffer with n-step sampling
(counterpart of ``harl_tpu/buffers/off_policy.py``), EP and FP layouts.

  * layout: a flat ring of ``buffer_size`` preallocated rows on the runner's
    device; one insert writes the ``n_rollout_threads`` rows of one step, so
    consecutive steps of one thread are ``n_threads`` rows apart;
  * ``next(idx) = (idx + (1 − end_flag[idx])·n_threads) % buffer_size``;
  * ``end_flag`` = dones, plus the newest row of every thread (its episode
    has not finished yet);
  * the n-step reward is accumulated backwards with restarts at end flags,
    and every sample carries its own γⁿ.

Per-agent obs, action and valid-transition columns are lists of tensors, so
heterogeneous widths need no padding. Under discrete actions each agent also
has availability rows before and after the step (``avail_dims``), sampled at
the start and at the last n-step row. ``idx`` and ``cur_size`` are host
ints: the host knows how many rows it inserted, so no insert or sample waits
on the device.

The FP layout (``ReplayBufferFP``, off_policy_buffer_fp.py) gives the
env-level fields — state, next state, rewards, dones, terms — an agent axis
(S, N, ·). Each agent walks its own n steps over its own end flags, and a
sample's env-level fields are agent-major (N·batch, ·) concatenations.

Every column is float32, so a ring of S rows holds
4·S·(E·(2·ds + 3) + 2·Σdo + Σda + N + 2·Σn) bytes, with E = 1 env-level row
a step (EP) or N (FP): state and next state, rewards, dones and terms;
obs and next obs, actions and valid masks per agent; availability before
and after the step under discrete actions. ``ring_nbytes`` gives it before
anything is allocated, ``nbytes`` of a live ring, and ``require_room``
refuses a ring larger than the room left.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch


class Sample(NamedTuple):
    """EP: env-level fields (batch, ·); FP: (N·batch, ·), agent-major."""

    share_obs: torch.Tensor                 # (batch, ds)
    obs: List[torch.Tensor]                 # per agent (batch, do_i)
    actions: List[torch.Tensor]             # per agent (batch, da_i)
    rewards: torch.Tensor                   # (batch, 1) n-step accumulated
    dones: torch.Tensor                     # (batch, 1) at the last n-step row
    valid_transitions: List[torch.Tensor]   # per agent (batch, 1)
    terms: torch.Tensor                     # (batch, 1) at the last n-step row
    next_share_obs: torch.Tensor
    next_obs: List[torch.Tensor]
    gamma: torch.Tensor                     # (batch, 1) per-sample γⁿ
    available_actions: Optional[List[torch.Tensor]] = None        # per agent (batch, n_i)
    next_available_actions: Optional[List[torch.Tensor]] = None


ENV_LEVEL = ("share_obs", "next_share_obs", "rewards", "dones", "terms")
PER_AGENT = ("obs", "next_obs", "actions", "valid_transitions")
AVAIL = ("available_actions", "next_available_actions")
GIB = 2 ** 30


def ring_columns(get) -> List[torch.Tensor]:
    """A ring's columns in one order, each field read with ``get(name)``:
    ``getattr`` of a live ring, or ``dict.get`` of its checkpoint payload."""
    out = [get(k) for k in ENV_LEVEL]
    for k in PER_AGENT + AVAIL:
        if get(k) is not None:
            out += list(get(k))
    return out


def require_room(need: int, free: int, what: str) -> None:
    """Raise ``ValueError`` naming both sizes where ``need`` bytes exceed
    the ``free`` bytes of ``what`` (a card's memory, a disk)."""
    if need > free:
        raise ValueError(f"{what}: {need} bytes ({need / GIB:.2f} GiB) needed, "
                         f"{free} bytes ({free / GIB:.2f} GiB) free")


class ReplayBuffer:
    """A ring of ``buffer_size`` rows; ``insert`` writes one step of B rows
    in place. With ``avail_dims`` (discrete actions), per-agent availability
    rows too."""

    env_axes: tuple = ()   # axes of the env-level fields after the row axis

    def __init__(self, buffer_size: int, share_obs_dim: int, obs_dims: Sequence[int],
                 act_dims: Sequence[int], device=None,
                 avail_dims: Optional[Sequence[int]] = None):
        S = buffer_size

        def z(d):
            return torch.zeros((S, d), device=device)

        def z_env(d):
            return torch.zeros((S, *self.env_axes, d), device=device)

        self.buffer_size = S
        self.share_obs, self.next_share_obs = z_env(share_obs_dim), z_env(share_obs_dim)
        self.obs = [z(d) for d in obs_dims]
        self.next_obs = [z(d) for d in obs_dims]
        self.actions = [z(d) for d in act_dims]
        self.valid_transitions = [torch.ones((S, 1), device=device) for _ in obs_dims]
        self.available_actions = None if avail_dims is None else [z(d) for d in avail_dims]
        self.next_available_actions = (None if avail_dims is None
                                       else [z(d) for d in avail_dims])
        self.rewards, self.dones, self.terms = z_env(1), z_env(1), z_env(1)
        self.idx = 0        # next row to write
        self.cur_size = 0   # rows written so far, at most S

    @classmethod
    def ring_nbytes(cls, buffer_size: int, share_obs_dim: int, obs_dims: Sequence[int],
                    act_dims: Sequence[int], avail_dims: Optional[Sequence[int]] = None,
                    env_rows: int = 1) -> int:
        """The bytes of a ring of these dimensions (the module's formula),
        ``env_rows`` env-level rows a step."""
        per_row = (env_rows * (2 * share_obs_dim + 3) + 2 * sum(obs_dims) + sum(act_dims)
                   + len(obs_dims) + 2 * sum(avail_dims or ()))
        return 4 * buffer_size * per_row

    def tensors(self) -> List[torch.Tensor]:
        """Every column of the ring (``ring_columns``' order)."""
        return ring_columns(lambda k: getattr(self, k))

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for t in self.tensors())

    def insert(self, batch: dict) -> None:
        """Write one vectorised step: ``batch`` has share_obs, next_share_obs,
        rewards, dones, terms (B, ·), or (B, N, ·) under FP, and per-agent
        lists obs, next_obs, actions, valid_transitions (B, ·), and
        available_actions, next_available_actions where the buffer keeps
        them."""
        S, B = self.buffer_size, batch["share_obs"].shape[0]
        # rows (idx + arange(B)) % S as at most two slices
        first = min(B, S - self.idx)
        spans = [(self.idx, 0, first)] + ([(0, first, B - first)] if first < B else [])
        pairs = [(getattr(self, k), batch[k]) for k in ENV_LEVEL]
        for k in PER_AGENT + (AVAIL if self.available_actions is not None else ()):
            pairs += list(zip(getattr(self, k), batch[k]))
        for dst, src in pairs:
            for row, start, n in spans:
                dst[row: row + n].copy_(src[start: start + n])
        self.idx = (self.idx + B) % S
        self.cur_size = min(self.cur_size + B, S)

    def end_flag(self, n_threads: int) -> torch.Tensor:
        """dones, plus each thread's newest row: (S,) bool (buffer_ep.py:156-164),
        under FP (S, N), the newest rows set for every agent."""
        cur = max(self.cur_size, 1)
        flag = self.dones[..., 0] > 0
        unfinished = (self.idx - 1 + cur - torch.arange(n_threads, device=flag.device)) % cur
        return flag.index_fill_(0, unfinished, True)

    def sample(self, batch_size: int, n_step: int, gamma: float, n_threads: int,
               noise=None, start: Optional[torch.Tensor] = None) -> Sample:
        """``batch_size`` starts drawn with replacement from the rows written
        (``noise.indices``), or ``start`` as given, each walked ``n_step``
        steps of its thread (buffer_ep.py:40-148)."""
        S = self.buffer_size
        end_flag = self.end_flag(n_threads).long()
        if start is None:
            start = noise.indices(batch_size, max(self.cur_size, 1))
        visited, idx = [], start
        for _ in range(n_step):
            visited.append(idx)
            idx = (idx + (1 - end_flag[idx]) * n_threads) % S
        final = visited[-1]
        # backwards over the walk: the reward restarts at an end flag, and
        # γ's exponent is the step count up to the first end flag
        rew = torch.zeros((start.shape[0], 1), device=start.device)
        steps = torch.full((start.shape[0],), float(n_step), device=start.device)
        for n in range(n_step - 1, -1, -1):
            now = visited[n]
            ef = end_flag[now] > 0
            steps = torch.where(ef, float(n + 1), steps)
            rew = torch.where(ef[:, None], 0.0, rew)
            rew = self.rewards[now] + gamma * rew
        take = lambda arr, i: arr.index_select(0, i)
        avail = self.available_actions is not None
        return Sample(
            share_obs=take(self.share_obs, start),
            obs=[take(o, start) for o in self.obs],
            actions=[take(a, start) for a in self.actions],
            rewards=rew,
            dones=take(self.dones, final),
            valid_transitions=[take(v, start) for v in self.valid_transitions],
            terms=take(self.terms, final),
            next_share_obs=take(self.next_share_obs, final),
            next_obs=[take(o, final) for o in self.next_obs],
            gamma=torch.pow(gamma, steps)[:, None],
            available_actions=[take(a, start) for a in self.available_actions] if avail else None,
            next_available_actions=([take(a, final) for a in self.next_available_actions]
                                    if avail else None),
        )


class ReplayBufferFP(ReplayBuffer):
    """The FP layout (off_policy_buffer_fp.py; JAX ``init_buffer_fp``): state,
    next state, rewards, dones and terms are (S, N, ·), one row per agent."""

    def __init__(self, buffer_size: int, n_agents: int, share_obs_dim: int,
                 obs_dims: Sequence[int], act_dims: Sequence[int], device=None,
                 avail_dims: Optional[Sequence[int]] = None):
        self.env_axes = (n_agents,)
        super().__init__(buffer_size, share_obs_dim, obs_dims, act_dims, device, avail_dims)

    @classmethod
    def ring_nbytes(cls, buffer_size: int, n_agents: int, share_obs_dim: int,
                    obs_dims: Sequence[int], act_dims: Sequence[int],
                    avail_dims: Optional[Sequence[int]] = None) -> int:
        """The bytes of an FP ring: N env-level rows a step."""
        return ReplayBuffer.ring_nbytes(buffer_size, share_obs_dim, obs_dims, act_dims,
                                        avail_dims, env_rows=n_agents)

    def sample(self, batch_size: int, n_step: int, gamma: float, n_threads: int,
               noise=None, start: Optional[torch.Tensor] = None) -> Sample:
        """JAX ``sample_fp`` (off_policy_buffer_fp.py:52-148): the same starts
        for every agent, each agent walked ``n_step`` steps of its thread over
        its own end flags, with its own rewards and γⁿ. Env-level outputs are
        agent-major (N·batch, ·); agent i's next obs and availability are
        taken at its own last row."""
        S, N = self.buffer_size, self.env_axes[0]
        end_flag = self.end_flag(n_threads).long()                       # (S, N)
        if start is None:
            start = noise.indices(batch_size, max(self.cur_size, 1))
        agent = torch.arange(N, device=start.device)[:, None]           # (N, 1)
        visited, idx = [], start.expand(N, -1)                           # (N, batch)
        for _ in range(n_step):
            visited.append(idx)
            idx = (idx + (1 - end_flag[idx, agent]) * n_threads) % S
        final = visited[-1]
        rew = torch.zeros((N, batch_size, 1), device=start.device)
        steps = torch.full((N, batch_size), float(n_step), device=start.device)
        for n in range(n_step - 1, -1, -1):
            now = visited[n]
            ef = end_flag[now, agent] > 0
            steps = torch.where(ef, float(n + 1), steps)
            rew = torch.where(ef[..., None], 0.0, rew)
            rew = self.rewards[now, agent] + gamma * rew
        flat = lambda x: x.reshape((N * batch_size,) + x.shape[2:])
        at_final = lambda arr: flat(arr[final, agent])
        take = lambda arr, i: arr.index_select(0, i)
        avail = self.available_actions is not None
        return Sample(
            share_obs=flat(take(self.share_obs, start).transpose(0, 1)),
            obs=[take(o, start) for o in self.obs],
            actions=[take(a, start) for a in self.actions],
            rewards=flat(rew),
            dones=at_final(self.dones),
            valid_transitions=[take(v, start) for v in self.valid_transitions],
            terms=at_final(self.terms),
            next_share_obs=at_final(self.next_share_obs),
            next_obs=[take(o, final[i]) for i, o in enumerate(self.next_obs)],
            gamma=flat(torch.pow(gamma, steps)[..., None]),
            available_actions=[take(a, start) for a in self.available_actions] if avail else None,
            next_available_actions=([take(a, final[i])
                                     for i, a in enumerate(self.next_available_actions)]
                                    if avail else None),
        )
