"""Action distributions (counterpart of ``harl_tpu/ops/distributions.py``).

Only the on-policy Box head is ported: ``DiagGaussian`` with a
state-independent learnable log_std parameterised as
``sigmoid(log_std / std_x_coef) * std_y_coef`` (distributions.py:76-89).
Sampling takes the standard-normal noise as an argument, so a caller (or a
test) decides where the noise comes from. Categorical and the squashed
Gaussian are on the roadmap.
"""
from __future__ import annotations

import dataclasses
import math

import torch

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


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
