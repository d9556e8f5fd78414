"""Off-policy actors (counterpart of ``harl_tpu/algos/off_policy_actors.py``):
HADDPG and HATD3 for Box actions, HASAC for Box (squashed Gaussian) and
Discrete (straight-through Gumbel) actions, HAD3QN (ε-greedy dueling Q) for
Discrete ones; MADDPG and MATD3 use the HADDPG and HATD3 actors (their
difference lives in the runner's update).

Every random draw is passed in as a tensor by the caller; each actor says
what it needs and draws it from the runner's noise source
(``utils/noise.py``): ``explore_noise`` for an exploration action,
``draw`` for HASAC's sample in an update, ``random_actions`` for the
warmup. Box actions go to the env and the buffer as values, Discrete ones
as indices (…, 1), MultiDiscrete ones (HASAC only) as indices (…, k); HASAC
hands the critic one-hot actions, a MultiDiscrete agent's as its
sub-actions' one-hots side by side.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import torch
from torch import nn

from harl_tpu_torch.algos.common import adam
from harl_tpu_torch.models.policies import (DeterministicPolicy, SquashedGaussianPolicy,
                                            StochasticMlpPolicy)
from harl_tpu_torch.models.values import DuelingQNet
from harl_tpu_torch.ops import distributions as D
from harl_tpu_torch.parallel.mesh import LOCAL, Mesh
from harl_tpu_torch.utils import spaces


@dataclasses.dataclass
class OffPolicyAgentState:
    net: nn.Module
    target: nn.Module
    opt: torch.optim.Adam
    log_alpha: Optional[torch.Tensor] = None      # HASAC auto-α (scalar) or None
    alpha_opt: Optional[torch.optim.Adam] = None


class _OffPolicyActor:
    kinds = ("Box",)

    def __init__(self, obs_dim: int, action_space, cfg: dict, device=None):
        self.kind = spaces.space_kind(action_space)
        if self.kind not in self.kinds:
            raise ValueError(f"{type(self).__name__} supports {self.kinds} action spaces, "
                             f"not {self.kind}")
        self.obs_dim = obs_dim
        self.action_space = action_space
        # width of the action in the env and the replay buffer
        if self.kind == "Box":
            self.act_dim = action_space.shape[0]
        else:
            self.act_dim = 1 if self.kind == "Discrete" else len(action_space.nvec)
        self.device = device
        self.lr = cfg["lr"]
        self.polyak = cfg["polyak"]
        self.hidden_sizes = tuple(cfg["hidden_sizes"])
        self.activation_func = cfg.get("activation_func", "relu")
        if self.kind == "Box":
            self.low, self.high = (torch.tensor(b, dtype=torch.float32, device=device)
                                   for b in (action_space.low, action_space.high))

    def _make_policy(self, generator) -> nn.Module:
        raise NotImplementedError

    def init(self, generator: Optional[torch.Generator] = None,
             mesh: Mesh = LOCAL) -> OffPolicyAgentState:
        """A fresh policy, its target (equal to it) and its Adam (summing
        the gradients over the ``mesh``'s ranks)."""
        net = self._make_policy(generator)
        return OffPolicyAgentState(net, copy.deepcopy(net).requires_grad_(False),
                                   adam(net.parameters(), self.lr, mesh))

    def explore_noise(self, noise, batch: int):
        """The draws of one exploration action: standard normals (batch, d)."""
        return noise.action_noise((batch, self.act_dim))

    def random_actions(self, noise, batch: int) -> torch.Tensor:
        """Uniform warmup actions: u·(high − low) + low from u on [0, 1),
        ``jax.random.uniform``'s arithmetic; a Discrete agent's index is
        drawn from ``randint``, a MultiDiscrete agent's indices from one
        ``randint`` a sub-action, in order (off_policy_actors.py:182-197)."""
        if self.kind == "Box":
            return noise.uniform((batch, self.act_dim)) * (self.high - self.low) + self.low
        if self.kind == "Discrete":
            return noise.randint((batch, 1), self.action_space.n)
        return torch.stack([noise.randint((batch,), int(n)) for n in self.action_space.nvec],
                           dim=-1)


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
                    noise: Optional[torch.Tensor] = None, available_actions=None) -> torch.Tensor:
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

    def deterministic_actions(self, net: nn.Module, obs: torch.Tensor,
                              available_actions=None) -> torch.Tensor:
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
    """Stochastic actor (hasac.py): a squashed Gaussian for Box actions
    (``act_limit`` is ``high[0]``), ``StochasticMlpPolicy`` with a
    straight-through Gumbel-softmax over masked logits for Discrete ones,
    and one per sub-head (unmasked) for MultiDiscrete ones
    (off_policy_actors.py:137-180)."""

    kinds = ("Box", "Discrete", "MultiDiscrete")

    def __init__(self, obs_dim: int, action_space, cfg: dict, device=None):
        super().__init__(obs_dim, action_space, cfg, device)
        if self.kind == "Box":
            self.act_limit = float(action_space.high[0])
        else:
            self.policy_kwargs = dict(
                use_feature_normalization=cfg.get("use_feature_normalization", True),
                initialization_method=cfg.get("initialization_method", "orthogonal_"),
                gain=cfg.get("gain", 0.01))

    def _make_policy(self, generator) -> nn.Module:
        if self.kind == "Box":
            return SquashedGaussianPolicy(self.obs_dim, self.act_dim, self.hidden_sizes,
                                          self.activation_func, self.device, generator)
        return StochasticMlpPolicy(self.obs_dim, self.action_space, self.hidden_sizes,
                                   self.activation_func, device=self.device,
                                   generator=generator, **self.policy_kwargs)

    def draw(self, noise, batch: int):
        """One sample's noise: standard normals (batch, d) for a Box,
        standard Gumbels (batch, n) for a Discrete space, and for a
        MultiDiscrete one a list of standard Gumbels (batch, nᵢ), one a
        sub-head in order."""
        if self.kind == "Box":
            return noise.action_noise((batch, self.act_dim))
        if self.kind == "Discrete":
            return noise.gumbel_noise((batch, self.action_space.n))
        return [noise.gumbel_noise((batch, int(n))) for n in self.action_space.nvec]

    explore_noise = draw

    def _logits(self, net: nn.Module, obs: torch.Tensor, available_actions) -> torch.Tensor:
        return D.mask_logits(net(obs)[0], available_actions)

    def get_actions_with_logprobs(self, net: nn.Module, obs: torch.Tensor, eps: torch.Tensor,
                                  available_actions: Optional[torch.Tensor] = None):
        """(actions, log-probs) for ``eps`` of ``draw``: a Box's actions
        scaled to act_limit, log-prob (…, 1); a Discrete space's
        straight-through one-hot, with log-prob Σ onehot·logits of the masked
        logits (hasac.py:59-77), (…, 1); a MultiDiscrete space's sub-heads'
        one-hots side by side, with one such log-prob a sub-head (…, k)."""
        if self.kind == "Box":
            mu, log_std = net(obs)
            s = D.squashed_gaussian_sample(mu, log_std, eps, self.act_limit)
            return s.action, s.log_prob
        if self.kind == "MultiDiscrete":
            heads = net(obs)
            onehots = [D.gumbel_softmax(logits, g, hard=True) for logits, g in zip(heads, eps)]
            return (torch.cat(onehots, dim=-1),
                    torch.cat([(oh * logits).sum(dim=-1, keepdim=True)
                               for oh, logits in zip(onehots, heads)], dim=-1))
        logits = self._logits(net, obs, available_actions)
        onehot = D.gumbel_softmax(logits, eps, hard=True)
        return onehot, (onehot * logits).sum(dim=-1, keepdim=True)

    def get_actions(self, net: nn.Module, obs: torch.Tensor, eps: torch.Tensor,
                    available_actions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Env-facing actions: a Box's values, a Discrete space's index
        (…, 1), a MultiDiscrete space's indices (…, k)."""
        if self.kind == "MultiDiscrete":
            return torch.cat([torch.argmax(D.gumbel_softmax(logits, g, hard=True), dim=-1,
                                           keepdim=True) for logits, g in zip(net(obs), eps)],
                             dim=-1)
        a, _ = self.get_actions_with_logprobs(net, obs, eps, available_actions)
        return a if self.kind == "Box" else torch.argmax(a, dim=-1, keepdim=True)

    def deterministic_actions(self, net: nn.Module, obs: torch.Tensor,
                              available_actions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The evaluation action (``stochastic=False``): tanh(μ)·act_limit,
        or the argmax of the masked logits."""
        if self.kind == "Box":
            mu, log_std = net(obs)
            return D.squashed_gaussian_sample(mu, log_std, None, self.act_limit,
                                              deterministic=True).action
        if self.kind == "MultiDiscrete":
            return torch.cat([torch.argmax(D.onehot_from_logits(logits), dim=-1, keepdim=True)
                              for logits in net(obs)], dim=-1)
        onehot = D.onehot_from_logits(self._logits(net, obs, available_actions))
        return torch.argmax(onehot, dim=-1, keepdim=True)


class HAD3QNActor(_OffPolicyActor):
    """Per-agent dueling Q network, ε-greedy (had3qn.py). Availability is
    not read, as in the reference."""

    kinds = ("Discrete",)

    def __init__(self, obs_dim: int, action_space, cfg: dict, device=None):
        super().__init__(obs_dim, action_space, cfg, device)
        self.action_dim = action_space.n
        self.epsilon = cfg["epsilon"]
        self.net_kwargs = dict(
            base_hidden_sizes=tuple(cfg.get("base_hidden_sizes", cfg["hidden_sizes"])),
            base_activation_func=cfg.get("base_activation_func", "relu"),
            dueling_v_hidden_sizes=tuple(cfg.get("dueling_v_hidden_sizes", [128])),
            dueling_v_activation_func=cfg.get("dueling_v_activation_func", "hardswish"),
            dueling_a_hidden_sizes=tuple(cfg.get("dueling_a_hidden_sizes", [128])),
            dueling_a_activation_func=cfg.get("dueling_a_activation_func", "hardswish"))

    def _make_policy(self, generator) -> nn.Module:
        return DuelingQNet(self.obs_dim, self.action_dim, device=self.device,
                           generator=generator, **self.net_kwargs)

    def explore_noise(self, noise, batch: int):
        """(random actions, coin): ``randint`` (batch, 1) over the actions,
        then ``uniform`` (batch, 1), in the JAX package's order."""
        return noise.randint((batch, 1), self.action_dim), noise.uniform((batch, 1))

    def get_actions(self, net: nn.Module, obs: torch.Tensor, noise=None,
                    available_actions=None) -> torch.Tensor:
        """argmax Q (…, 1); with ``noise`` of ``explore_noise``, the random
        action where the coin falls below ε."""
        greedy = torch.argmax(net(obs), dim=-1, keepdim=True)
        if noise is None:
            return greedy
        rand, coin = noise
        return torch.where(coin < self.epsilon, rand, greedy)

    def get_target_actions(self, target: nn.Module, obs: torch.Tensor) -> torch.Tensor:
        return torch.argmax(target(obs), dim=-1, keepdim=True)

    def train_values(self, net: nn.Module, obs: torch.Tensor,
                     actions: torch.Tensor) -> torch.Tensor:
        """Q(o, a) at integer actions (…, 1) (had3qn.py:56-67)."""
        return torch.take_along_dim(net(obs), actions.long(), dim=-1)

    def deterministic_actions(self, net: nn.Module, obs: torch.Tensor,
                              available_actions=None) -> torch.Tensor:
        return self.get_actions(net, obs)
