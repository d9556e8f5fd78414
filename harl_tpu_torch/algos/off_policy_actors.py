"""Off-policy actors (counterpart of ``harl_tpu/algos/off_policy_actors.py``):
HADDPG, HATD3 and HASAC for Box actions; MADDPG and MATD3 use the HADDPG
and HATD3 actors (their difference lives in the runner's update).

Every random draw is passed in as a tensor by the caller (the runner takes
it from its noise source): standard normals for exploration, target
smoothing and the squashed Gaussian, uniforms on [0, 1) for the warmup
actions. Discrete and MultiDiscrete HASAC (ST-Gumbel) and HAD3QN are on
the roadmap.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import torch
from torch import nn

from harl_tpu_torch.algos.common import adam
from harl_tpu_torch.algos.q_critics import require_box
from harl_tpu_torch.models.policies import DeterministicPolicy, SquashedGaussianPolicy
from harl_tpu_torch.ops.distributions import squashed_gaussian_sample


@dataclasses.dataclass
class OffPolicyAgentState:
    net: nn.Module
    target: nn.Module
    opt: torch.optim.Adam
    log_alpha: Optional[torch.Tensor] = None      # HASAC auto-α (scalar) or None
    alpha_opt: Optional[torch.optim.Adam] = None


class _OffPolicyActor:
    def __init__(self, obs_dim: int, action_space, cfg: dict, device=None):
        require_box([action_space])
        self.obs_dim = obs_dim
        self.action_space = action_space
        self.act_dim = action_space.shape[0]
        self.device = device
        self.lr = cfg["lr"]
        self.polyak = cfg["polyak"]
        self.hidden_sizes = tuple(cfg["hidden_sizes"])
        self.activation_func = cfg.get("activation_func", "relu")
        self.low, self.high = (torch.tensor(b, dtype=torch.float32, device=device)
                               for b in (action_space.low, action_space.high))

    def _make_policy(self, generator) -> nn.Module:
        raise NotImplementedError

    def init(self, generator: Optional[torch.Generator] = None) -> OffPolicyAgentState:
        """A fresh policy, its target (equal to it) and its Adam."""
        net = self._make_policy(generator)
        return OffPolicyAgentState(net, copy.deepcopy(net).requires_grad_(False),
                                   adam(net.parameters(), self.lr))

    def random_actions(self, u: torch.Tensor) -> torch.Tensor:
        """Uniform warmup actions from ``u`` on [0, 1): u·(high − low) + low,
        ``jax.random.uniform``'s arithmetic."""
        return u * (self.high - self.low) + self.low


class HADDPGActor(_OffPolicyActor):
    """Deterministic policy with Gaussian exploration noise (haddpg.py:30-43)."""

    def __init__(self, obs_dim: int, action_space, cfg: dict, device=None):
        super().__init__(obs_dim, action_space, cfg, device)
        self.scale = (self.high - self.low) / 2.0
        self.expl_noise = cfg["expl_noise"]
        self.final_activation_func = cfg.get("final_activation_func", "tanh")

    def _make_policy(self, generator) -> nn.Module:
        return DeterministicPolicy(self.obs_dim, self.action_space.low, self.action_space.high,
                                   self.hidden_sizes, self.activation_func,
                                   self.final_activation_func, self.device, generator)

    def get_actions(self, net: nn.Module, obs: torch.Tensor,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """π(obs); with standard-normal ``noise``, plus noise·expl_noise·scale
        clipped to [low, high]."""
        actions = net(obs)
        if noise is not None:
            actions = torch.clamp(actions + noise * self.expl_noise * self.scale,
                                  self.low, self.high)
        return actions

    def get_target_actions(self, target: nn.Module, obs: torch.Tensor,
                           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return target(obs)

    def deterministic_actions(self, net: nn.Module, obs: torch.Tensor) -> torch.Tensor:
        """π(obs) without exploration noise: the evaluation action."""
        return net(obs)


class HATD3Actor(HADDPGActor):
    """Adds clipped target-policy smoothing noise (hatd3.py:13-28)."""

    def __init__(self, obs_dim: int, action_space, cfg: dict, device=None):
        super().__init__(obs_dim, action_space, cfg, device)
        self.policy_noise = cfg["policy_noise"]
        self.noise_clip = cfg["noise_clip"]

    def get_target_actions(self, target: nn.Module, obs: torch.Tensor,
                           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """π′(obs) plus standard-normal ``noise``·policy_noise·scale, clipped
        to ±noise_clip·scale, then the sum clipped to [low, high]."""
        actions = target(obs)
        clip = self.noise_clip * self.scale
        noise = torch.clamp(noise * self.policy_noise * self.scale, -clip, clip)
        return torch.clamp(actions + noise, self.low, self.high)


class HASACActor(_OffPolicyActor):
    """Squashed Gaussian stochastic actor (hasac.py), Box branch;
    ``act_limit`` is ``high[0]``."""

    def __init__(self, obs_dim: int, action_space, cfg: dict, device=None):
        super().__init__(obs_dim, action_space, cfg, device)
        self.act_limit = float(action_space.high[0])

    def _make_policy(self, generator) -> nn.Module:
        return SquashedGaussianPolicy(self.obs_dim, self.act_dim, self.hidden_sizes,
                                      self.activation_func, self.device, generator)

    def get_actions_with_logprobs(self, net: nn.Module, obs: torch.Tensor, eps: torch.Tensor):
        """(actions scaled to act_limit, log-probs (…, 1)) for standard-normal
        ``eps`` of the action's shape."""
        mu, log_std = net(obs)
        s = squashed_gaussian_sample(mu, log_std, eps, self.act_limit)
        return s.action, s.log_prob

    def get_actions(self, net: nn.Module, obs: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        return self.get_actions_with_logprobs(net, obs, eps)[0]

    def deterministic_actions(self, net: nn.Module, obs: torch.Tensor) -> torch.Tensor:
        """tanh(μ)·act_limit: the evaluation action (``stochastic=False``)."""
        mu, log_std = net(obs)
        return squashed_gaussian_sample(mu, log_std, None, self.act_limit, deterministic=True).action
