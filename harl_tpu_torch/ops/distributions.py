"""Action distributions (counterpart of ``harl_tpu/ops/distributions.py``).

The on-policy heads are ported:

* ``Categorical`` over logits with unavailable actions masked to −1e10
  (distributions.py:51-55); sampling is Gumbel-max, ``argmax(logits + g)``
  with standard Gumbel noise ``g`` passed in, which is how
  ``jax.random.categorical`` samples;
* ``DiagGaussian`` with a state-independent learnable log_std parameterised
  as ``sigmoid(log_std / std_x_coef) * std_y_coef`` (distributions.py:76-89);
  sampling takes standard-normal noise as an argument.

* ``squashed_gaussian_sample``, HASAC's tanh-squashed Gaussian
  (distributions.py:120-147), with the standard-normal draw passed in;
* ``gumbel_softmax`` (straight-through, ``hard=True``) and
  ``onehot_from_logits``, discrete HASAC's sample and mode
  (distributions.py:154-166), with the standard Gumbel draw passed in.

So a caller (or a test) decides where the noise comes from.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

MASK_LOGIT = -1e10
_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def mask_logits(logits: torch.Tensor, available_actions: Optional[torch.Tensor]) -> torch.Tensor:
    """Set logits of unavailable actions to −1e10 (distributions.py:51-55)."""
    if available_actions is None:
        return logits
    return torch.where(available_actions == 0, MASK_LOGIT, logits)


@dataclasses.dataclass
class Categorical:
    """Categorical over the last axis of ``logits`` (already masked)."""

    logits: torch.Tensor  # (..., n)

    def log_probs_all(self) -> torch.Tensor:
        return torch.log_softmax(self.logits, dim=-1)

    def sample(self, gumbel: torch.Tensor) -> torch.Tensor:
        """Gumbel-max sample (..., 1) for standard Gumbel noise (..., n)."""
        return torch.argmax(self.logits + gumbel, dim=-1, keepdim=True)

    def mode(self) -> torch.Tensor:
        return torch.argmax(self.logits, dim=-1, keepdim=True)

    def log_prob(self, action: torch.Tensor) -> torch.Tensor:
        """Log-prob of integer actions (..., 1) → (..., 1)."""
        return torch.take_along_dim(self.log_probs_all(), action.long(), dim=-1)

    def entropy(self) -> torch.Tensor:
        """−Σ p·log p, shape (...,). A masked action has p = 0 exactly and
        log p ≈ −1e10: the ``p > 0`` guard keeps 0·(−1e10) out of the sum."""
        lp = self.log_probs_all()
        p = torch.exp(lp)
        return -torch.where(p > 0, p * lp, 0.0).sum(dim=-1)


def categorical(logits: torch.Tensor,
                available_actions: Optional[torch.Tensor] = None) -> Categorical:
    return Categorical(mask_logits(logits, available_actions))


@dataclasses.dataclass
class DiagGaussian:
    mean: torch.Tensor  # (..., d)
    std: torch.Tensor   # (..., d) or (d,)

    def sample(self, noise: torch.Tensor) -> torch.Tensor:
        """mean + std·noise for given standard-normal ``noise`` (…, d)."""
        return self.mean + torch.broadcast_to(self.std, self.mean.shape) * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def log_prob(self, action: torch.Tensor) -> torch.Tensor:
        """Per-dimension log-prob (…, d), not summed over dims
        (FixedNormal.log_probs)."""
        var = self.std ** 2
        return -((action - self.mean) ** 2) / (2 * var) - torch.log(self.std) - _LOG_SQRT_2PI

    def entropy(self) -> torch.Tensor:
        """Summed over action dims, shape (…,)."""
        ent = 0.5 + _LOG_SQRT_2PI + torch.log(torch.broadcast_to(self.std, self.mean.shape))
        return ent.sum(dim=-1)


def diag_gaussian_std(log_std: torch.Tensor, std_x_coef: float,
                      std_y_coef: float) -> torch.Tensor:
    """sigmoid(log_std/std_x_coef)·std_y_coef (distributions.py:87)."""
    return torch.sigmoid(log_std / std_x_coef) * std_y_coef


# The JAX package's floor on the squashed Gaussian's log-std, -5 (std >=
# 6.7e-3), not the reference's -20: it bounds the per-dim log-prob where the
# std head saturates (distributions.py:111-121).
LOG_STD_MIN = -5.0
LOG_STD_MAX = 2.0


class SquashedGaussianSample(NamedTuple):
    action: torch.Tensor    # (..., d), scaled to act_limit
    log_prob: torch.Tensor  # (..., 1), summed over dims with the tanh correction


def squashed_gaussian_sample(mu: torch.Tensor, log_std: torch.Tensor,
                             eps: Optional[torch.Tensor], act_limit: float,
                             deterministic: bool = False) -> SquashedGaussianSample:
    """mu + std·eps, tanh-squashed and scaled to ``act_limit``; ``eps`` is
    standard-normal noise of mu's shape (unused when ``deterministic``).
    The log-prob subtracts Σ 2(log 2 − a − softplus(−2a))."""
    log_std = torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)
    std = torch.exp(log_std)
    pre = mu if deterministic else mu + std * eps
    logp = (-((pre - mu) ** 2) / (2 * std ** 2) - log_std - _LOG_SQRT_2PI).sum(
        dim=-1, keepdim=True)
    correction = 2.0 * (math.log(2.0) - pre - F.softplus(-2.0 * pre))
    logp = logp - correction.sum(dim=-1, keepdim=True)
    return SquashedGaussianSample(torch.tanh(pre) * act_limit, logp)


def onehot_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """The argmax as a one-hot row of ``logits``' dtype (discrete_util.py:8-16)."""
    return F.one_hot(torch.argmax(logits, dim=-1), logits.shape[-1]).to(logits.dtype)


def gumbel_softmax(logits: torch.Tensor, gumbel: torch.Tensor, temperature: float = 1.0,
                   hard: bool = True) -> torch.Tensor:
    """softmax((logits + g)/temperature) for standard Gumbel ``gumbel`` of
    logits' shape; with ``hard``, the straight-through one-hot
    ``y_hard + y − stop_gradient(y)``: the argmax forward, softmax's
    gradient backward (discrete_util.py:44-59)."""
    y = torch.softmax((logits + gumbel) / temperature, dim=-1)
    if hard:
        y = onehot_from_logits(y) + y - y.detach()
    return y
