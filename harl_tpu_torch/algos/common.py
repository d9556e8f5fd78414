"""Shared algorithm plumbing (counterpart of ``harl_tpu/algos/common.py``):
train states, the optimizers, losses, ratio aggregation, polyak target
updates, and how an update cuts its batch into minibatch rows."""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List, NamedTuple, Optional

import torch
from torch import nn

from harl_tpu_torch.parallel.mesh import LOCAL, Mesh
from harl_tpu_torch.utils.checkpoint import steps_on_cpu


class ClippedAdam:
    """Global-norm gradient clip, then ``torch.optim.Adam(eps=opti_eps)`` —
    the JAX package's ``optax.chain(clip_by_global_norm, adam)`` — or, with
    ``weight_decay``, ``torch.optim.AdamW``: optax's ``adamw`` decays every
    parameter by lr·wd·p in the same scheduled step, as AdamW does with its
    group's lr, so the clip stays before the decay and a linear lr decay
    scales both.

    The clip is written out because ``optax.clip_by_global_norm`` leaves the
    gradients alone below the limit and scales them by ``max/norm`` above
    it, where ``torch.nn.utils.clip_grad_norm_`` always scales by
    ``max/(norm + 1e-6)`` clamped to 1. optax's Adam and torch's agree,
    bias correction included.

    With ``lr_schedule``, each step first sets every param group's ``lr`` to
    ``lr_schedule(count)``, ``count`` the steps taken before this one: optax
    evaluates a schedule on the same count.

    The gradients are summed over the ``mesh``'s ranks (``parallel/mesh.py``;
    ``LOCAL``, one rank, by default) in one bucketed all-reduce before the
    norm and the clip: every replica then clips alike and takes the same
    step.
    """

    def __init__(self, params: Iterable[nn.Parameter], lr: float, eps: float = 1e-5,
                 max_grad_norm: Optional[float] = None,
                 lr_schedule: Optional[Callable[[int], float]] = None,
                 weight_decay: float = 0.0, mesh: Mesh = LOCAL):
        self.params: List[nn.Parameter] = list(params)
        self.max_grad_norm = max_grad_norm
        self.lr_schedule = lr_schedule
        self.mesh = mesh
        self.count = 0
        self.adam = (torch.optim.AdamW(self.params, lr=lr, eps=eps, weight_decay=weight_decay)
                     if weight_decay else torch.optim.Adam(self.params, lr=lr, eps=eps))

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip the gradients in place, step Adam; returns the pre-clip
        global norm (the reported ``grad_norm``)."""
        self.mesh.all_reduce_grads_(self.params)
        grads = [p.grad for p in self.params if p.grad is not None]
        gnorm = global_grad_norm(grads)
        if self.max_grad_norm is not None:
            clip_by_global_norm_(grads, gnorm, self.max_grad_norm)
        if self.lr_schedule is not None:
            for group in self.adam.param_groups:
                group["lr"] = self.lr_schedule(self.count)
        self.adam.step()
        self.count += 1
        return gnorm

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, sd: dict) -> None:
        """Adam's moments and step counts; the lr stays the live config's,
        as an optax state holds no lr."""
        lrs = [g["lr"] for g in self.adam.param_groups]
        self.adam.load_state_dict(steps_on_cpu(self.adam, sd["adam"]))
        for g, lr in zip(self.adam.param_groups, lrs):
            g["lr"] = lr
        self.count = int(sd["count"])


def clip_by_global_norm_(grads: List[torch.Tensor], gnorm: torch.Tensor,
                         max_norm: float) -> None:
    """optax.clip_by_global_norm in place: g if norm < max else g/norm·max.
    Stays on the device (no host sync on the norm)."""
    keep = gnorm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / gnorm * max_norm))


def global_grad_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """L2 norm over all gradients (models_tools.py:110-117)."""
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


@dataclasses.dataclass
class AgentTrainState:
    """A network and its optimizer (the JAX package's params + opt_state)."""

    net: nn.Module
    opt: ClippedAdam


def linear_lr_schedule(lr: float, total_updates: int,
                       updates_per_iteration: int) -> Callable[[int], float]:
    """The JAX package's linear decay (common.py:39-43, update_linear_schedule
    of models_tools.py:77-87): lr·(1 − min(it / E, 1)) with it = count //
    updates_per_iteration, stepped once per training iteration."""
    def schedule(count: int) -> float:
        it = count // max(updates_per_iteration, 1)
        return lr * (1.0 - min(it / max(total_updates, 1), 1.0))

    return schedule


def make_optimizer(params, lr: float, opti_eps: float = 1e-5, weight_decay: float = 0.0,
                   max_grad_norm: Optional[float] = None,
                   use_linear_lr_decay: bool = False, total_updates: int = 1,
                   updates_per_iteration: int = 1, mesh: Mesh = LOCAL) -> ClippedAdam:
    """The JAX package's ``make_optimizer``: Adam (AdamW with a weight
    decay) after the optional clip, with the optional linear lr decay over
    ``total_updates`` iterations of ``updates_per_iteration`` optimizer
    steps each."""
    schedule = (linear_lr_schedule(lr, total_updates, updates_per_iteration)
                if use_linear_lr_decay else None)
    return ClippedAdam(params, lr, opti_eps, max_grad_norm, schedule, weight_decay, mesh)


class MeshAdam(torch.optim.Adam):
    """``torch.optim.Adam`` that sums the gradients over the ``mesh``'s
    ranks (one bucketed all-reduce) before its step."""

    def __init__(self, params, lr: float, eps: float, mesh: Mesh = LOCAL):
        super().__init__(params, lr=lr, eps=eps)
        self.mesh = mesh

    @torch.no_grad()
    def step(self, closure=None):
        self.mesh.all_reduce_grads_([p for g in self.param_groups for p in g["params"]])
        return super().step(closure)


def adam(params, lr: float, mesh: Mesh = LOCAL) -> MeshAdam:
    """The off-policy networks' ``optax.adam(lr)``: eps 1e-8, no clip
    (off_policy_actors.py:57,122, q_critics.py:88-89)."""
    return MeshAdam(params, lr, 1e-8, mesh)


@torch.no_grad()
def soft_update(target: nn.Module, source: nn.Module, polyak: float) -> None:
    """θ′ ← (1−τ)θ′ + τθ over the parameters, in place (common.py:85-87),
    written out as the JAX package writes it: two products and a sum, each
    rounded (``torch.lerp`` rounds otherwise)."""
    t = list(target.parameters())
    torch._foreach_mul_(t, 1.0 - polyak)
    torch._foreach_add_(t, torch._foreach_mul(list(source.parameters()), polyak))


def huber_loss(error: torch.Tensor, delta: float) -> torch.Tensor:
    """Elementwise huber (models_tools.py:64-69)."""
    a = error.abs()
    quad = torch.clamp(a, max=delta)
    return 0.5 * quad ** 2 + delta * (a - quad)


def mse_loss(error: torch.Tensor) -> torch.Tensor:
    """Elementwise e²/2 (models_tools.py:72-74)."""
    return 0.5 * error ** 2


def aggregate_ratio(delta_logp: torch.Tensor, action_aggregation: str) -> torch.Tensor:
    """prod/mean of exp(Δlogp) over the last axis, keepdims
    (happo.py:66-70, on_policy_ha_runner.py:116-124)."""
    r = torch.exp(delta_logp)
    if action_aggregation == "prod":
        return r.prod(dim=-1, keepdim=True)
    if action_aggregation == "mean":
        return r.mean(dim=-1, keepdim=True)
    raise ValueError(action_aggregation)


def flat(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if x is None else x.reshape((-1,) + tuple(x.shape[2:]))


def time_major(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if x is None else x.transpose(0, 1)


class Share(NamedTuple):
    """A rank's part of an update (``parallel/mesh.py``): the global column
    of each of its batch's columns (host int64) among ``total`` global
    ones. Every loss is the rank's sum over a global count."""

    mesh: Mesh
    cols: torch.Tensor
    total: int

    @staticmethod
    def whole(total: int) -> "Share":
        """All ``total`` columns on one rank (``LOCAL``)."""
        return Share(LOCAL, torch.arange(total), total)


class Chunking:
    """How an update cuts a (T, B, ·) batch into minibatch rows: T·B steps,
    or C = B·T/L chunks of L steps for a recurrent network
    (on_policy_actor_buffer.py:180-326)."""

    def __init__(self, cfg: dict):
        self.use_recurrent_policy = cfg.get("use_recurrent_policy", False)
        self.use_rnn = self.use_recurrent_policy or cfg.get("use_naive_recurrent_policy", False)
        self.data_chunk_length = cfg.get("data_chunk_length", 10)

    def chunk_length(self, T: int) -> int:
        L = self.data_chunk_length if self.use_recurrent_policy else T
        if T % L:
            raise ValueError(f"episode_length {T} is not a multiple of data_chunk_length {L}")
        return L

    def rows(self, T: int, B: int) -> int:
        """Minibatch rows of a (T, B) batch: what a shuffle permutes."""
        return B * (T // self.chunk_length(T)) if self.use_rnn else T * B

    def prep(self, x: Optional[torch.Tensor], T: int) -> Optional[torch.Tensor]:
        """(T, B, …) → rows: (T·B, …) or (C, L, …)."""
        if x is None or not self.use_rnn:
            return flat(x)
        L = self.chunk_length(T)
        x = x.transpose(0, 1)
        return x.reshape((-1, L) + tuple(x.shape[2:]))

    def first_states(self, rnn_states: torch.Tensor, T: int) -> torch.Tensor:
        """Each chunk's initial hidden state (C, recurrent_n, H)."""
        L = self.chunk_length(T)
        r = rnn_states.transpose(0, 1)[:, ::L]
        return r.reshape((-1,) + tuple(rnn_states.shape[2:]))

    def steps(self, epochs: int, num_mini_batch: int, T: int, share: Share,
              perms: Optional[torch.Tensor], device):
        """The ``epochs`` × ``num_mini_batch`` minibatches of the per-epoch
        shuffles ``perms`` (epochs, global rows) on a rank's share: per step
        the rank's rows of the global minibatch (local indices in the
        minibatch's order, maybe none; None: every local row) and the
        minibatch's global count of time steps. A global row is t·B + b, or
        b·(T/L) + c for chunks, so a rank owns the rows of its env columns."""
        M = self.rows(T, share.total)
        per_row = self.chunk_length(T) if self.use_rnn else 1
        if num_mini_batch == 1:
            # a full-batch gradient does not depend on the order: no gather
            return [(None, M * per_row)] * epochs
        if perms is None or tuple(perms.shape) != (epochs, M):
            raise ValueError(f"need perms of shape {(epochs, M)}")
        cols = share.cols
        if self.use_rnn:
            C = T // self.chunk_length(T)
            gid = (cols[:, None] * C + torch.arange(C)).reshape(-1)
        else:
            gid = (torch.arange(T)[:, None] * share.total + cols[None, :]).reshape(-1)
        inv = torch.full((M,), -1, dtype=torch.long)
        inv[gid] = torch.arange(gid.numel())
        out = []
        for idx in perms.cpu().reshape(epochs * num_mini_batch, M // num_mini_batch):
            local = inv[idx]
            out.append((local[local >= 0].to(device), (M // num_mini_batch) * per_row))
        return out
