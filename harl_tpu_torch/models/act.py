"""Action heads and sample/evaluate (counterpart of ``harl_tpu/models/act.py``).

Only the Box branch is ported: a linear mean head plus a state-independent
``log_std`` parameter initialised to ``std_x_coef`` (act.py:52-63). The head
returns (mean, log_std); sampling and evaluation are functions over it, with
the Gaussian noise passed in. Discrete heads are on the roadmap.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from harl_tpu_torch.models.mlp import get_init, make_linear
from harl_tpu_torch.ops import distributions as D
from harl_tpu_torch.utils import spaces


def _require_box(action_space) -> None:
    kind = spaces.space_kind(action_space)
    if kind != "Box":
        raise NotImplementedError(
            f"{kind} action heads are not ported yet (ROADMAP.md, recurrent discrete path)")


class ACTLayer(nn.Module):
    """Linear DiagGaussian head over features (act.py:24-63, Box branch)."""

    def __init__(self, in_dim: int, action_space, initialization_method: str = "orthogonal_",
                 gain: float = 0.01, std_x_coef: float = 1.0, device=None, generator=None):
        super().__init__()
        _require_box(action_space)
        d = action_space.shape[0]
        self.head = make_linear(in_dim, d, get_init(initialization_method, gain),
                                device, generator)
        # sigmoid(1)·std_y_coef is the initial std (distributions.py:83-85)
        self.log_std = nn.Parameter(
            torch.full((d,), float(std_x_coef), dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mean = self.head(x)
        return mean, torch.broadcast_to(self.log_std, mean.shape)


class ActOutput(NamedTuple):
    actions: torch.Tensor    # (…, d)
    log_probs: torch.Tensor  # (…, d) per-dim


def act_sample(noise: Optional[torch.Tensor], head_out, action_space,
               deterministic: bool = False, std_x_coef: float = 1.0,
               std_y_coef: float = 0.5) -> ActOutput:
    """Sample (or mode) + log-prob (act.py:71-101, Box branch); ``noise`` is
    standard normal, shaped like the mean."""
    _require_box(action_space)
    mean, log_std = head_out
    dist = D.DiagGaussian(mean, D.diag_gaussian_std(log_std, std_x_coef, std_y_coef))
    a = dist.mode() if deterministic else dist.sample(noise)
    return ActOutput(a, dist.log_prob(a))


class ActEval(NamedTuple):
    log_probs: torch.Tensor
    entropy: torch.Tensor  # scalar


def act_evaluate(head_out, action_space, action: torch.Tensor,
                 active_masks: Optional[torch.Tensor] = None,
                 std_x_coef: float = 1.0, std_y_coef: float = 0.5) -> ActEval:
    """Log-prob of given actions + entropy, Σ(ent·mask)/Σmask with active
    masks, else the mean (act.py:109-149, Box branch)."""
    _require_box(action_space)
    mean, log_std = head_out
    dist = D.DiagGaussian(mean, D.diag_gaussian_std(log_std, std_x_coef, std_y_coef))
    lp = dist.log_prob(action)
    ent = dist.entropy()
    if active_masks is not None:
        am = active_masks[..., 0]
        entropy = (ent * am).sum() / torch.clamp(am.sum(), min=1e-9)
    else:
        entropy = ent.mean()
    return ActEval(lp, entropy)
