"""Value-function models (counterpart of ``harl_tpu/models/values.py``).

``VNet``: MLPBase (CNNBase for an (H, W, C) state) → optional GRU → scalar
head with the configured init at gain 1.0 (v_net.py:41-44).
``ContinuousQNet``: Q(s, joint action) on a PlainMLP, for the off-policy
critics. ``DuelingQNet``: HAD3QN's per-agent Q(o, ·) and joint Q(s, ·).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from harl_tpu_torch.models.mlp import PlainMLP, get_init, make_linear
from harl_tpu_torch.models.policies import make_base, recurrent_inputs
from harl_tpu_torch.models.rnn import GRUStack


class VNet(nn.Module):
    """Centralized V(s): ``forward(cent_obs, rnn_states, masks, seq)`` →
    (values (…, 1), new rnn states)."""

    def __init__(self, in_dim, hidden_sizes: Sequence[int] = (128, 128),
                 activation_func: str = "relu", use_feature_normalization: bool = True,
                 initialization_method: str = "orthogonal_",
                 use_recurrent_policy: bool = False, recurrent_n: int = 1,
                 device=None, generator=None):
        super().__init__()
        self.base = make_base(in_dim, hidden_sizes, activation_func, use_feature_normalization,
                              initialization_method, device, generator)
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


class ContinuousQNet(nn.Module):
    """Q(s, joint a) (continuous_q_net.py): concat(state, joint action) →
    PlainMLP → scalar. Callers concatenate the agents' actions."""

    def __init__(self, share_obs_dim: int, joint_action_dim: int,
                 hidden_sizes: Sequence[int] = (256, 256), activation_func: str = "relu",
                 device=None, generator=None):
        super().__init__()
        self.mlp = PlainMLP(share_obs_dim + joint_action_dim, tuple(hidden_sizes) + (1,),
                            activation_func, "identity", device, generator)

    def forward(self, cent_obs: torch.Tensor, joint_actions: torch.Tensor) -> torch.Tensor:
        return self.mlp(torch.cat([cent_obs, joint_actions], dim=-1))


class DuelingQNet(nn.Module):
    """Dueling Q network (dueling_q_net.py): a PlainMLP torso, then a value
    head V (→ 1) and an advantage head A (→ ``output_dim``), each a PlainMLP
    ending without an activation; Q = A − mean(A) + V."""

    def __init__(self, in_dim: int, output_dim: int,
                 base_hidden_sizes: Sequence[int] = (128, 128),
                 base_activation_func: str = "relu",
                 dueling_v_hidden_sizes: Sequence[int] = (128,),
                 dueling_v_activation_func: str = "hardswish",
                 dueling_a_hidden_sizes: Sequence[int] = (128,),
                 dueling_a_activation_func: str = "hardswish", device=None, generator=None):
        super().__init__()
        self.base = PlainMLP(in_dim, tuple(base_hidden_sizes), base_activation_func,
                             base_activation_func, device, generator)
        h = base_hidden_sizes[-1]
        self.dueling_v = PlainMLP(h, tuple(dueling_v_hidden_sizes) + (1,),
                                  dueling_v_activation_func, "identity", device, generator)
        self.dueling_a = PlainMLP(h, tuple(dueling_a_hidden_sizes) + (output_dim,),
                                  dueling_a_activation_func, "identity", device, generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = self.base(obs)
        a = self.dueling_a(x)
        return a - a.mean(dim=-1, keepdim=True) + self.dueling_v(x)
