"""Shared algorithm plumbing (counterpart of ``harl_tpu/algos/common.py``):
train states, the optimizer, losses and ratio aggregation."""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional

import torch
from torch import nn


class ClippedAdam:
    """Global-norm gradient clip, then ``torch.optim.Adam(eps=opti_eps)`` —
    the JAX package's ``optax.chain(clip_by_global_norm, adam)``.

    The clip is written out because ``optax.clip_by_global_norm`` leaves the
    gradients alone below the limit and scales them by ``max/norm`` above
    it, where ``torch.nn.utils.clip_grad_norm_`` always scales by
    ``max/(norm + 1e-6)`` clamped to 1. optax's Adam and torch's agree,
    bias correction included.
    """

    def __init__(self, params: Iterable[nn.Parameter], lr: float, eps: float = 1e-5,
                 max_grad_norm: Optional[float] = None):
        self.params: List[nn.Parameter] = list(params)
        self.max_grad_norm = max_grad_norm
        self.adam = torch.optim.Adam(self.params, lr=lr, eps=eps)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip the gradients in place, step Adam; returns the pre-clip
        global norm (the reported ``grad_norm``)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        gnorm = global_grad_norm(grads)
        if self.max_grad_norm is not None:
            clip_by_global_norm_(grads, gnorm, self.max_grad_norm)
        self.adam.step()
        return gnorm


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


def make_optimizer(params, lr: float, opti_eps: float = 1e-5, weight_decay: float = 0.0,
                   max_grad_norm: Optional[float] = None,
                   use_linear_lr_decay: bool = False) -> ClippedAdam:
    """The JAX package's ``make_optimizer`` for its default settings."""
    if weight_decay or use_linear_lr_decay:
        raise NotImplementedError(
            "weight decay and linear lr decay are not ported yet "
            "(ROADMAP.md, options of the ported modules)")
    return ClippedAdam(params, lr, opti_eps, max_grad_norm)


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
