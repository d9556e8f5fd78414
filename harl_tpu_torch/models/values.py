"""Value-function models (counterpart of ``harl_tpu/models/values.py``).

``VNet``: MLPBase → optional GRU → scalar head with the configured init at
gain 1.0 (v_net.py:41-44). The CNN path is on the roadmap.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from harl_tpu_torch.models.mlp import MLPBase, get_init, make_linear
from harl_tpu_torch.models.policies import recurrent_inputs
from harl_tpu_torch.models.rnn import GRUStack


class VNet(nn.Module):
    """Centralized V(s): ``forward(cent_obs, rnn_states, masks, seq)`` →
    (values (…, 1), new rnn states)."""

    def __init__(self, in_dim: int, hidden_sizes: Sequence[int] = (128, 128),
                 activation_func: str = "relu", use_feature_normalization: bool = True,
                 initialization_method: str = "orthogonal_",
                 use_recurrent_policy: bool = False, recurrent_n: int = 1,
                 device=None, generator=None):
        super().__init__()
        self.base = MLPBase(in_dim, hidden_sizes, activation_func,
                            use_feature_normalization, initialization_method,
                            device, generator)
        self.rnn = (GRUStack(hidden_sizes[-1], hidden_sizes[-1], recurrent_n, device, generator)
                    if use_recurrent_policy else None)
        self.v_out = make_linear(hidden_sizes[-1], 1, get_init(initialization_method, 1.0),
                                 device, generator)

    def forward(self, cent_obs: torch.Tensor, rnn_states: Optional[torch.Tensor] = None,
                masks: Optional[torch.Tensor] = None,
                seq: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        x = self.base(cent_obs)
        if self.rnn is not None:
            rnn_states, masks = recurrent_inputs(x, rnn_states, masks, self.rnn.recurrent_n,
                                                 self.rnn.hidden_size)
            x, rnn_states = self.rnn(x, rnn_states, masks, seq)
        return self.v_out(x), rnn_states
