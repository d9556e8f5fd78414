"""Off-policy joint-action Q critics (counterpart of
``harl_tpu/algos/q_critics.py``).

  * ``ContinuousQCritic`` — one Q(s, joint a), n-step target
    r + γⁿ·Q′·(1 − term) (``dones`` in place of ``terms`` without
    ``use_proper_time_limits``);
  * ``TwinContinuousQCritic`` — twin Qs, the min of the twin targets, one
    Adam over both nets;
  * ``SoftTwinContinuousQCritic`` — the SAC target r + γⁿ(min Q′ − α·logπ′)
    (1 − term), optional ValueNorm on the targets (updated on the
    de-normalised targets, then applied), Huber loss, critic-side auto-α.

The loss is Huber or err² (no ½), summed over the twins. Box actions only;
one-hot joint actions of discrete spaces and ``DiscreteQCritic`` (HAD3QN)
are on the roadmap.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import torch
from torch import nn

from harl_tpu_torch.algos.common import adam, huber_loss, soft_update
from harl_tpu_torch.models.values import ContinuousQNet
from harl_tpu_torch.ops.value_norm import (ValueNormState, denormalize, init_value_norm,
                                           normalize, update_value_norm)
from harl_tpu_torch.utils import spaces

DISCRETE_TODO = ("discrete and MultiDiscrete off-policy actions (one-hot joint actions, "
                 "ST-Gumbel HASAC, HAD3QN) are not ported yet (ROADMAP.md, Queue A: what "
                 "the off-policy path left)")


def require_box(act_spaces) -> None:
    if any(spaces.space_kind(sp) != "Box" for sp in act_spaces):
        raise NotImplementedError(DISCRETE_TODO)


@dataclasses.dataclass
class QCriticState:
    nets: nn.ModuleList          # (q1,) or (q1, q2)
    targets: nn.ModuleList
    opt: torch.optim.Adam        # one Adam over every net
    log_alpha: Optional[torch.Tensor] = None     # soft critic auto-α
    alpha_opt: Optional[torch.optim.Adam] = None
    value_norm: Optional[ValueNormState] = None


class ContinuousQCritic:
    """Single Q(s, joint a) (continuous_q_critic.py)."""

    n_q = 1
    soft = False

    def __init__(self, share_obs_dim: int, act_spaces, cfg: dict, device=None):
        self.share_obs_dim = share_obs_dim
        self.act_spaces = act_spaces
        self.device = device
        self.critic_lr = cfg["critic_lr"]
        self.polyak = cfg["polyak"]
        self.use_proper_time_limits = cfg.get("use_proper_time_limits", True)
        self.use_huber_loss = cfg.get("use_huber_loss", False)
        self.huber_delta = cfg.get("huber_delta", 10.0)
        self.auto_alpha = cfg.get("auto_alpha", False)
        self.alpha_lr = cfg.get("alpha_lr", 3e-4)
        self.use_valuenorm = cfg.get("use_valuenorm", False) and self.soft
        self.hidden_sizes = tuple(cfg["hidden_sizes"])
        self.activation_func = cfg.get("activation_func", "relu")
        require_box(act_spaces)
        self.joint_dim = sum(sp.shape[0] for sp in act_spaces)

    def init(self, generator: Optional[torch.Generator] = None) -> QCriticState:
        nets = nn.ModuleList(
            ContinuousQNet(self.share_obs_dim, self.joint_dim, self.hidden_sizes,
                           self.activation_func, self.device, generator)
            for _ in range(self.n_q))
        targets = copy.deepcopy(nets).requires_grad_(False)
        log_alpha = alpha_opt = None
        if self.soft and self.auto_alpha:
            log_alpha = torch.zeros((), device=self.device, requires_grad=True)
            alpha_opt = adam([log_alpha], self.alpha_lr)
        return QCriticState(
            nets, targets, adam(nets.parameters(), self.critic_lr), log_alpha, alpha_opt,
            init_value_norm(1, device=self.device) if self.use_valuenorm else None)

    # -- evaluation ---------------------------------------------------------
    @staticmethod
    def _min_q(nets: nn.ModuleList, share_obs, joint_actions) -> torch.Tensor:
        qs = [net(share_obs, joint_actions) for net in nets]
        return qs[0] if len(qs) == 1 else torch.minimum(qs[0], qs[1])

    def get_values(self, state: QCriticState, share_obs, joint_actions) -> torch.Tensor:
        return self._min_q(state.nets, share_obs, joint_actions)

    # -- training -----------------------------------------------------------
    def train(self, state: QCriticState, sample, next_joint_actions: torch.Tensor,
              next_logp: Optional[torch.Tensor] = None,
              alpha=None) -> torch.Tensor:
        """One Adam step on the n-step TD loss; updates ``state`` in place
        and returns the loss (a tensor on the device)."""
        joint_actions = torch.cat(sample.actions, dim=-1)   # Box actions: the joint action
        with torch.no_grad():
            next_q = self._min_q(state.targets, sample.next_share_obs, next_joint_actions)
            not_end = 1.0 - (sample.terms if self.use_proper_time_limits else sample.dones)
            vn = state.value_norm
            if self.soft:
                if vn is not None:
                    q_targets = sample.rewards + sample.gamma * (
                        denormalize(vn, next_q) - alpha * next_logp) * not_end
                    vn = update_value_norm(vn, q_targets)
                    q_targets = normalize(vn, q_targets)
                else:
                    q_targets = sample.rewards + sample.gamma * (
                        next_q - alpha * next_logp) * not_end
            else:
                q_targets = sample.rewards + sample.gamma * next_q * not_end
        loss = 0.0
        for net in state.nets:
            err = net(sample.share_obs, joint_actions) - q_targets
            e = huber_loss(err, self.huber_delta) if self.use_huber_loss else err ** 2
            loss = loss + e.mean()
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        state.opt.step()
        state.value_norm = vn
        return loss.detach()

    def update_alpha(self, state: QCriticState, logp_sum: torch.Tensor,
                     target_entropy: float) -> None:
        """Critic-side auto-α (soft_twin_continuous_q_critic.py:44-57), log α
        clamped to [−16, 2] after the step (q_critics.py:179-197)."""
        loss = -(state.log_alpha * (logp_sum + target_entropy).detach()).mean()
        state.alpha_opt.zero_grad(set_to_none=True)
        loss.backward()
        state.alpha_opt.step()
        with torch.no_grad():
            state.log_alpha.clamp_(-16.0, 2.0)

    def soft_update_targets(self, state: QCriticState) -> None:
        soft_update(state.targets, state.nets, self.polyak)


class TwinContinuousQCritic(ContinuousQCritic):
    """Twin Qs with the min target (twin_continuous_q_critic.py)."""

    n_q = 2


class SoftTwinContinuousQCritic(TwinContinuousQCritic):
    """SAC target with the entropy term and optional ValueNorm
    (soft_twin_continuous_q_critic.py); Huber loss unless disabled."""

    soft = True

    def __init__(self, share_obs_dim: int, act_spaces, cfg: dict, device=None):
        super().__init__(share_obs_dim, act_spaces, cfg, device)
        self.use_huber_loss = cfg.get("use_huber_loss", True)
