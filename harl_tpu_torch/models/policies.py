"""Policy models (counterpart of ``harl_tpu/models/policies.py``).

``StochasticPolicy``: MLPBase, or CNNBase for (H, W, C) observations →
optional GRU → ACTLayer. The off-policy actors: ``SquashedGaussianPolicy`` (HASAC, Box)
and ``DeterministicPolicy`` (HADDPG/HATD3/MADDPG/MATD3), on ``PlainMLP``,
and ``StochasticMlpPolicy`` (HASAC, Discrete and MultiDiscrete): MLPBase → ACTLayer.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from harl_tpu_torch.models.act import ACTLayer
from harl_tpu_torch.models.cnn import CNNBase
from harl_tpu_torch.models.mlp import MLPBase, PlainMLP, lecun_normal_, make_linear
from harl_tpu_torch.models.rnn import GRUStack


def make_base(obs_dim, hidden_sizes, activation_func, use_feature_normalization,
              initialization_method, device, generator) -> nn.Module:
    """The torso: ``MLPBase`` for an int ``obs_dim``, ``CNNBase`` for an
    (H, W, C) shape (stochastic_policy.py:34-36, v_net.py:30-32)."""
    if isinstance(obs_dim, (tuple, list)):
        return CNNBase(tuple(obs_dim), hidden_sizes, activation_func, initialization_method,
                       device=device, generator=generator)
    return MLPBase(obs_dim, hidden_sizes, activation_func, use_feature_normalization,
                   initialization_method, device, generator)


def recurrent_inputs(x: torch.Tensor, rnn_states: Optional[torch.Tensor],
                     masks: Optional[torch.Tensor], recurrent_n: int, hidden: int):
    """Zero hidden states and unit masks where the caller passes none
    (policies.py:55-60): hidden (N, recurrent_n, H) for the batch axis N."""
    if rnn_states is None:
        rnn_states = x.new_zeros((x.shape[-2], recurrent_n, hidden))
    if masks is None:
        masks = x.new_ones(x.shape[:-1] + (1,))
    return rnn_states, masks


class StochasticPolicy(nn.Module):
    """MLPBase (or CNNBase) → optional GRU → ACTLayer
    (stochastic_policy.py:14-86). ``obs_dim`` is an int, or (H, W, C) for
    pixel observations.

    ``forward(obs, rnn_states, masks, seq)`` → (head outputs, new rnn
    states); the states pass through unchanged (None) without a GRU."""

    def __init__(self, obs_dim, action_space, hidden_sizes: Sequence[int] = (128, 128),
                 activation_func: str = "relu", use_feature_normalization: bool = True,
                 initialization_method: str = "orthogonal_", gain: float = 0.01,
                 use_recurrent_policy: bool = False, recurrent_n: int = 1,
                 std_x_coef: float = 1.0, device=None, generator=None):
        super().__init__()
        self.base = make_base(obs_dim, hidden_sizes, activation_func, use_feature_normalization,
                              initialization_method, device, generator)
        self.rnn = (GRUStack(hidden_sizes[-1], hidden_sizes[-1], recurrent_n, device, generator)
                    if use_recurrent_policy else None)
        self.act = ACTLayer(hidden_sizes[-1], action_space, initialization_method,
                            gain, std_x_coef, device, generator)

    def forward(self, obs: torch.Tensor, rnn_states: Optional[torch.Tensor] = None,
                masks: Optional[torch.Tensor] = None,
                seq: bool = False) -> Tuple[Tuple[torch.Tensor, ...], Optional[torch.Tensor]]:
        x = self.base(obs)
        if self.rnn is not None:
            rnn_states, masks = recurrent_inputs(x, rnn_states, masks, self.rnn.recurrent_n,
                                                 self.rnn.hidden_size)
            x, rnn_states = self.rnn(x, rnn_states, masks, seq)
        return self.act(x), rnn_states


class StochasticMlpPolicy(nn.Module):
    """Discrete HASAC's policy (stochastic_mlp_policy.py): MLPBase →
    ACTLayer, no GRU and no masks. ``forward(obs)`` → the head's outputs,
    ``(logits,)`` for a Discrete space."""

    def __init__(self, obs_dim: int, action_space, hidden_sizes: Sequence[int] = (128, 128),
                 activation_func: str = "relu", use_feature_normalization: bool = True,
                 initialization_method: str = "orthogonal_", gain: float = 0.01,
                 device=None, generator=None):
        super().__init__()
        self.base = MLPBase(obs_dim, hidden_sizes, activation_func,
                            use_feature_normalization, initialization_method,
                            device, generator)
        self.act = ACTLayer(hidden_sizes[-1], action_space, initialization_method,
                            gain, device=device, generator=generator)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self.act(self.base(obs))


class SquashedGaussianPolicy(nn.Module):
    """SAC policy (squashed_gaussian_policy.py): PlainMLP torso → ``mu`` and
    ``log_std`` heads. ``forward(obs)`` → (mu, log_std); the squash and the
    log-prob correction are ``ops.distributions.squashed_gaussian_sample``."""

    def __init__(self, obs_dim: int, act_dim: int, hidden_sizes: Sequence[int] = (256, 256),
                 activation_func: str = "relu", device=None, generator=None):
        super().__init__()
        self.net = PlainMLP(obs_dim, hidden_sizes, activation_func, activation_func,
                            device, generator)
        h = hidden_sizes[-1]
        self.mu = make_linear(h, act_dim, lecun_normal_, device, generator)
        self.log_std = make_linear(h, act_dim, lecun_normal_, device, generator)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.net(obs)
        return self.mu(x), self.log_std(x)


class DeterministicPolicy(nn.Module):
    """DDPG/TD3 actor (deterministic_policy.py): PlainMLP with a final
    activation (tanh) rescaled affinely to [low, high]."""

    def __init__(self, obs_dim: int, low: Sequence[float], high: Sequence[float],
                 hidden_sizes: Sequence[int] = (256, 256), activation_func: str = "relu",
                 final_activation_func: str = "tanh", device=None, generator=None):
        super().__init__()
        self.pi = PlainMLP(obs_dim, tuple(hidden_sizes) + (len(low),), activation_func,
                           final_activation_func, device, generator)
        low = torch.tensor(low, dtype=torch.float32, device=device)
        high = torch.tensor(high, dtype=torch.float32, device=device)
        self.register_buffer("half_range", (high - low) / 2.0, persistent=False)
        self.register_buffer("mid", (high + low) / 2.0, persistent=False)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.half_range * self.pi(obs) + self.mid
