"""Action heads and sample/evaluate (counterpart of ``harl_tpu/models/act.py``).

Head output convention, per action space:

* Discrete → ``(logits,)``: one linear head (act.py:42-45); availability
  masks set unavailable logits to −1e10 in sample and evaluate;
* MultiDiscrete → ``(logits_0, …, logits_{k−1})``: one linear head
  ``head{i}`` per sub-action (act.py:46-51), never masked;
* Box → ``(mean, log_std)``: a linear mean head plus a state-independent
  ``log_std`` parameter initialised to ``std_x_coef`` (act.py:52-63).

Sampling and evaluation are functions over the head's output, with the
noise passed in: standard Gumbel for Discrete, one standard Gumbel tensor a
sub-head (in sub-head order) for MultiDiscrete, standard normal for Box.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from harl_tpu_torch.models.mlp import get_init, make_linear
from harl_tpu_torch.ops import distributions as D
from harl_tpu_torch.utils import spaces


class ACTLayer(nn.Module):
    """Linear Categorical, MultiCategorical or DiagGaussian head over
    features (act.py:24-63)."""

    def __init__(self, in_dim: int, action_space, initialization_method: str = "orthogonal_",
                 gain: float = 0.01, std_x_coef: float = 1.0, device=None, generator=None):
        super().__init__()
        self.kind = spaces.space_kind(action_space)
        init = get_init(initialization_method, gain)
        if self.kind == "MultiDiscrete":
            self.n_heads = len(action_space.nvec)
            for i, n in enumerate(action_space.nvec):
                setattr(self, f"head{i}", make_linear(in_dim, int(n), init, device, generator))
            return
        d = action_space.n if self.kind == "Discrete" else action_space.shape[0]
        self.head = make_linear(in_dim, d, init, device, generator)
        if self.kind == "Box":
            # sigmoid(1)·std_y_coef is the initial std (distributions.py:83-85)
            self.log_std = nn.Parameter(
                torch.full((d,), float(std_x_coef), dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        if self.kind == "MultiDiscrete":
            return tuple(getattr(self, f"head{i}")(x) for i in range(self.n_heads))
        out = self.head(x)
        if self.kind == "Discrete":
            return (out,)
        return out, torch.broadcast_to(self.log_std, out.shape)


class ActOutput(NamedTuple):
    actions: torch.Tensor    # Discrete (…, 1) int64; MultiDiscrete (…, k) int64; Box (…, d)
    log_probs: torch.Tensor  # Discrete and MultiDiscrete (…, 1); Box (…, d) per-dim


def act_sample(noise, head_out, action_space,
               available_actions: Optional[torch.Tensor] = None,
               deterministic: bool = False, std_x_coef: float = 1.0,
               std_y_coef: float = 0.5) -> ActOutput:
    """Sample (or mode) + log-prob (act.py:71-101). ``noise`` is shaped like
    the head's first output: standard Gumbel (Discrete) or normal (Box); for
    MultiDiscrete a sequence of standard Gumbels, one per sub-head, and the
    log-prob is the sum over sub-heads."""
    kind = spaces.space_kind(action_space)
    if kind == "Discrete":
        dist = D.categorical(head_out[0], available_actions)
        a = dist.mode() if deterministic else dist.sample(noise)
        return ActOutput(a, dist.log_prob(a))
    if kind == "MultiDiscrete":
        acts, lps = [], []
        for i, logits in enumerate(head_out):
            dist = D.categorical(logits, None)
            a = dist.mode() if deterministic else dist.sample(noise[i])
            acts.append(a)
            lps.append(dist.log_prob(a))
        return ActOutput(torch.cat(acts, dim=-1),
                         torch.cat(lps, dim=-1).sum(dim=-1, keepdim=True))
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
                 std_x_coef: float = 1.0, std_y_coef: float = 0.5,
                 entropy_denom: Optional[torch.Tensor] = None) -> ActEval:
    """Log-prob of given actions + entropy, Σ(ent·mask)/Σmask with active
    masks, else the mean (act.py:109-149); ``entropy_denom`` replaces Σmask
    (a data-parallel rank's share: the global count). MultiDiscrete: the log-prob is
    the sum over sub-heads, the entropy the sum of the sub-entropies before
    the masked mean (the reference broadcasts the mask wrongly there,
    act.py:127-133; the JAX package's fix is kept)."""
    kind = spaces.space_kind(action_space)
    if kind == "MultiDiscrete":
        dists = [D.categorical(logits, None) for logits in head_out]
        lp = torch.cat([d.log_prob(action[..., i: i + 1]) for i, d in enumerate(dists)],
                       dim=-1).sum(dim=-1, keepdim=True)
        ent = sum(d.entropy() for d in dists)
    else:
        if kind == "Discrete":
            dist = D.categorical(head_out[0], available_actions)
        else:
            mean, log_std = head_out
            dist = D.DiagGaussian(mean, D.diag_gaussian_std(log_std, std_x_coef, std_y_coef))
        lp = dist.log_prob(action)
        ent = dist.entropy()
    am = torch.ones_like(ent) if active_masks is None else active_masks[..., 0]
    denom = am.sum() if entropy_denom is None else entropy_denom
    entropy = (ent * am).sum() / torch.clamp(denom, min=1e-9)
    return ActEval(lp, entropy)
