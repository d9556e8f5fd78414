"""Action heads and sample/evaluate (counterpart of ``harl_tpu/models/act.py``).

Head output convention, per action space:

* Discrete → ``(logits,)``: one linear head (act.py:42-45); availability
  masks set unavailable logits to −1e10 in sample and evaluate;
* Box → ``(mean, log_std)``: a linear mean head plus a state-independent
  ``log_std`` parameter initialised to ``std_x_coef`` (act.py:52-63).

Sampling and evaluation are functions over the head's output, with the
noise passed in: standard Gumbel for Discrete, standard normal for Box.
MultiDiscrete heads are on the roadmap.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from harl_tpu_torch.models.mlp import get_init, make_linear
from harl_tpu_torch.ops import distributions as D
from harl_tpu_torch.utils import spaces


def _kind(action_space) -> str:
    kind = spaces.space_kind(action_space)
    if kind not in ("Box", "Discrete"):
        raise NotImplementedError(
            f"{kind} action heads are not ported yet (ROADMAP.md, MultiDiscrete heads)")
    return kind


class ACTLayer(nn.Module):
    """Linear Categorical or DiagGaussian head over features (act.py:24-63)."""

    def __init__(self, in_dim: int, action_space, initialization_method: str = "orthogonal_",
                 gain: float = 0.01, std_x_coef: float = 1.0, device=None, generator=None):
        super().__init__()
        self.discrete = _kind(action_space) == "Discrete"
        d = action_space.n if self.discrete else action_space.shape[0]
        self.head = make_linear(in_dim, d, get_init(initialization_method, gain),
                                device, generator)
        if not self.discrete:
            # sigmoid(1)·std_y_coef is the initial std (distributions.py:83-85)
            self.log_std = nn.Parameter(
                torch.full((d,), float(std_x_coef), dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        out = self.head(x)
        if self.discrete:
            return (out,)
        return out, torch.broadcast_to(self.log_std, out.shape)


class ActOutput(NamedTuple):
    actions: torch.Tensor    # Discrete (…, 1) int64; Box (…, d)
    log_probs: torch.Tensor  # Discrete (…, 1); Box (…, d) per-dim


def act_sample(noise: Optional[torch.Tensor], head_out, action_space,
               available_actions: Optional[torch.Tensor] = None,
               deterministic: bool = False, std_x_coef: float = 1.0,
               std_y_coef: float = 0.5) -> ActOutput:
    """Sample (or mode) + log-prob (act.py:71-101). ``noise`` is shaped like
    the head's first output: standard Gumbel (Discrete) or normal (Box)."""
    if _kind(action_space) == "Discrete":
        dist = D.categorical(head_out[0], available_actions)
        a = dist.mode() if deterministic else dist.sample(noise)
        return ActOutput(a, dist.log_prob(a))
    mean, log_std = head_out
    dist = D.DiagGaussian(mean, D.diag_gaussian_std(log_std, std_x_coef, std_y_coef))
    a = dist.mode() if deterministic else dist.sample(noise)
    return ActOutput(a, dist.log_prob(a))


class ActEval(NamedTuple):
    log_probs: torch.Tensor
    entropy: torch.Tensor  # scalar


def act_evaluate(head_out, action_space, action: torch.Tensor,
                 available_actions: Optional[torch.Tensor] = None,
                 active_masks: Optional[torch.Tensor] = None,
                 std_x_coef: float = 1.0, std_y_coef: float = 0.5) -> ActEval:
    """Log-prob of given actions + entropy, Σ(ent·mask)/Σmask with active
    masks, else the mean (act.py:109-149)."""
    if _kind(action_space) == "Discrete":
        dist = D.categorical(head_out[0], available_actions)
    else:
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
