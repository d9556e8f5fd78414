"""Policy models (counterpart of ``harl_tpu/models/policies.py``).

``StochasticPolicy``, MLP path: MLPBase → ACTLayer. The GRU and CNN paths
are on the roadmap.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from harl_tpu_torch.models.act import ACTLayer
from harl_tpu_torch.models.mlp import MLPBase


class StochasticPolicy(nn.Module):
    """MLPBase → ACTLayer (stochastic_policy.py:14-86); ``forward(obs)`` →
    head outputs (mean, log_std)."""

    def __init__(self, obs_dim: int, action_space, hidden_sizes: Sequence[int] = (128, 128),
                 activation_func: str = "relu", use_feature_normalization: bool = True,
                 initialization_method: str = "orthogonal_", gain: float = 0.01,
                 use_recurrent_policy: bool = False, std_x_coef: float = 1.0,
                 device=None, generator=None):
        super().__init__()
        if use_recurrent_policy:
            raise NotImplementedError(
                "recurrent policies are not ported yet (ROADMAP.md, recurrent discrete path)")
        self.base = MLPBase(obs_dim, hidden_sizes, activation_func,
                            use_feature_normalization, initialization_method,
                            device, generator)
        self.act = ACTLayer(hidden_sizes[-1], action_space, initialization_method,
                            gain, std_x_coef, device, generator)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.act(self.base(obs))
