"""Value-function models (counterpart of ``harl_tpu/models/values.py``).

``VNet``, MLP path: MLPBase → scalar head with the configured init at gain
1.0 (v_net.py:41-44). The GRU and CNN paths are on the roadmap.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from harl_tpu_torch.models.mlp import MLPBase, get_init, make_linear


class VNet(nn.Module):
    """Centralized V(s): ``forward(cent_obs)`` → (…, 1)."""

    def __init__(self, in_dim: int, hidden_sizes: Sequence[int] = (128, 128),
                 activation_func: str = "relu", use_feature_normalization: bool = True,
                 initialization_method: str = "orthogonal_",
                 use_recurrent_policy: bool = False, device=None, generator=None):
        super().__init__()
        if use_recurrent_policy:
            raise NotImplementedError(
                "recurrent critics are not ported yet (ROADMAP.md, recurrent discrete path)")
        self.base = MLPBase(in_dim, hidden_sizes, activation_func,
                            use_feature_normalization, initialization_method,
                            device, generator)
        self.v_out = make_linear(hidden_sizes[-1], 1, get_init(initialization_method, 1.0),
                                 device, generator)

    def forward(self, cent_obs: torch.Tensor) -> torch.Tensor:
        return self.v_out(self.base(cent_obs))
