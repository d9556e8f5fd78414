"""Off-policy joint-action Q critics (counterpart of
``harl_tpu/algos/q_critics.py``).

  * ``ContinuousQCritic`` — one Q(s, joint a), n-step target
    r + γⁿ·Q′·(1 − term) (``dones`` in place of ``terms`` without
    ``use_proper_time_limits``);
  * ``TwinContinuousQCritic`` — twin Qs, the min of the twin targets, one
    Adam over both nets;
  * ``SoftTwinContinuousQCritic`` — the SAC target r + γⁿ(min Q′ − α·logπ′)
    (1 − term), optional ValueNorm on the targets (updated on the
    de-normalised targets, then applied), Huber loss, critic-side auto-α;
    a Discrete agent's action enters the joint action one-hot, a
    MultiDiscrete agent's as the concatenated one-hots of its sub-actions;
  * ``DiscreteQCritic`` — HAD3QN's one ``DuelingQNet`` over the joint action
    space ∏ nᵢ, with the mixed-radix joint ↔ individual codecs and an MSE
    TD step.

The continuous critics' loss is Huber or err² (no ½), summed over the twins.
Under an FP state (``_fp_agents`` N > 1 in the config) a sample's env-level
fields are agent-major (N·batch, ·), so the joint actions, next joint actions
and next log-probabilities are tiled N times over the rows, and the soft
critic with ``use_policy_active_masks`` averages its loss over valid
transitions only (soft_twin_continuous_q_critic.py:128-147, 175-237).

A rank of a data-parallel ``mesh`` (``parallel/mesh.py``; one rank by
default) trains on its block of the sample's rows (``train(…, mesh,
rows)``): every mean is its sum over the global ``rows``, the
valid-transition count and the ValueNorm moments are all-reduced, and the
Adams sum the gradients over the ranks.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from harl_tpu_torch.algos.common import adam, huber_loss, soft_update
from harl_tpu_torch.models.values import ContinuousQNet, DuelingQNet
from harl_tpu_torch.ops.value_norm import (ValueNormState, denormalize, init_value_norm,
                                           normalize, update_value_norm)
from harl_tpu_torch.parallel.mesh import LOCAL, Mesh
from harl_tpu_torch.utils import spaces

def onehot_dim(space) -> int:
    """An agent's width in the joint action: a Box's dim, a Discrete's n,
    a MultiDiscrete's Σ nvec (off_policy_actors.py:125-132)."""
    kind = spaces.space_kind(space)
    if kind == "Box":
        return space.shape[0]
    if kind == "Discrete":
        return space.n
    return int(sum(space.nvec))


def encode_joint_actions(actions, act_spaces) -> torch.Tensor:
    """The agents' buffer actions as one joint action: Box actions as they
    are, a Discrete agent's index one-hot, a MultiDiscrete agent's indices
    as their one-hots side by side (q_critics.py:39-59)."""
    enc = []
    for a, sp in zip(actions, act_spaces):
        kind = spaces.space_kind(sp)
        if kind == "Box":
            enc.append(a)
        else:
            ns = (sp.n,) if kind == "Discrete" else sp.nvec
            enc += [F.one_hot(a[..., i].long(), int(n)).to(torch.float32)
                    for i, n in enumerate(ns)]
    return torch.cat(enc, dim=-1)


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
        self.use_policy_active_masks = cfg.get("use_policy_active_masks", True)
        self.fp_agents = cfg.get("_fp_agents", 1)
        self.hidden_sizes = tuple(cfg["hidden_sizes"])
        self.activation_func = cfg.get("activation_func", "relu")
        self.joint_dim = sum(onehot_dim(sp) for sp in act_spaces)

    def init(self, generator: Optional[torch.Generator] = None,
             mesh: Mesh = LOCAL) -> QCriticState:
        nets = nn.ModuleList(
            ContinuousQNet(self.share_obs_dim, self.joint_dim, self.hidden_sizes,
                           self.activation_func, self.device, generator)
            for _ in range(self.n_q))
        targets = copy.deepcopy(nets).requires_grad_(False)
        log_alpha = alpha_opt = None
        if self.soft and self.auto_alpha:
            log_alpha = torch.zeros((), device=self.device, requires_grad=True)
            alpha_opt = adam([log_alpha], self.alpha_lr, mesh)
        return QCriticState(
            nets, targets, adam(nets.parameters(), self.critic_lr, mesh), log_alpha, alpha_opt,
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
              alpha=None, mesh: Mesh = LOCAL, rows: Optional[int] = None) -> torch.Tensor:
        """One Adam step on the n-step TD loss; updates ``state`` in place
        and returns the loss (a tensor on the device): this rank's share of
        it, its sum over ``rows`` global rows (by default its own)."""
        joint_actions = encode_joint_actions(sample.actions, self.act_spaces)
        valid = None
        if self.fp_agents > 1:
            tile = lambda x: x.repeat(self.fp_agents, 1)
            joint_actions, next_joint_actions = tile(joint_actions), tile(next_joint_actions)
            if next_logp is not None:
                next_logp = tile(next_logp)
            if self.soft and self.use_policy_active_masks:
                valid = torch.cat(sample.valid_transitions, dim=0)          # (N·batch, 1)
        with torch.no_grad():
            next_q = self._min_q(state.targets, sample.next_share_obs, next_joint_actions)
            not_end = 1.0 - (sample.terms if self.use_proper_time_limits else sample.dones)
            vn = state.value_norm
            if self.soft:
                if vn is not None:
                    q_targets = sample.rewards + sample.gamma * (
                        denormalize(vn, next_q) - alpha * next_logp) * not_end
                    vn = update_value_norm(vn, q_targets, mesh=mesh)
                    q_targets = normalize(vn, q_targets)
                else:
                    q_targets = sample.rewards + sample.gamma * (
                        next_q - alpha * next_logp) * not_end
            else:
                q_targets = sample.rewards + sample.gamma * next_q * not_end
        if valid is not None:
            (denom,) = mesh.all_reduce_sum([valid.sum()])
        loss = 0.0
        for net in state.nets:
            err = net(sample.share_obs, joint_actions) - q_targets
            e = huber_loss(err, self.huber_delta) if self.use_huber_loss else err ** 2
            if valid is not None:
                loss = loss + (e * valid).sum() / torch.clamp(denom, min=1e-9)
            else:
                loss = loss + e.sum() / (rows or e.numel())
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        state.opt.step()
        state.value_norm = vn
        return loss.detach()

    def update_alpha(self, state: QCriticState, logp_sum: torch.Tensor,
                     target_entropy: float, rows: Optional[int] = None) -> None:
        """Critic-side auto-α (soft_twin_continuous_q_critic.py:44-57), log α
        clamped to [−16, 2] after the step (q_critics.py:179-197); the mean
        is the sum over ``rows`` global rows (by default this rank's)."""
        loss = state.log_alpha * (logp_sum + target_entropy).detach()
        loss = -loss.sum() / (rows or loss.numel())
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


class DiscreteQCritic:
    """Joint-action dueling Q critic of HAD3QN (discrete_q_critic.py): one
    ``DuelingQNet`` over the joint action space ∏ nᵢ; joint index
    Σᵢ aᵢ·∏_{j<i} nⱼ, agent 0 the least significant digit."""

    def __init__(self, share_obs_dim: int, act_spaces, cfg: dict, device=None):
        if any(spaces.space_kind(sp) != "Discrete" for sp in act_spaces):
            raise ValueError("DiscreteQCritic needs Discrete action spaces")
        self.share_obs_dim = share_obs_dim
        self.act_spaces = act_spaces
        self.device = device
        self.action_dims = [sp.n for sp in act_spaces]
        self.joint_action_dim = math.prod(self.action_dims)
        self.critic_lr = cfg["critic_lr"]
        self.polyak = cfg["polyak"]
        self.use_proper_time_limits = cfg.get("use_proper_time_limits", True)
        self.net_kwargs = dict(
            base_hidden_sizes=tuple(cfg.get("base_hidden_sizes", cfg["hidden_sizes"])),
            base_activation_func=cfg.get("base_activation_func", "relu"),
            dueling_v_hidden_sizes=tuple(cfg.get("dueling_v_hidden_sizes", [128])),
            dueling_v_activation_func=cfg.get("dueling_v_activation_func", "hardswish"),
            dueling_a_hidden_sizes=tuple(cfg.get("dueling_a_hidden_sizes", [128])),
            dueling_a_activation_func=cfg.get("dueling_a_activation_func", "hardswish"))

    def init(self, generator: Optional[torch.Generator] = None,
             mesh: Mesh = LOCAL) -> QCriticState:
        nets = nn.ModuleList([DuelingQNet(self.share_obs_dim, self.joint_action_dim,
                                          device=self.device, generator=generator,
                                          **self.net_kwargs)])
        targets = copy.deepcopy(nets).requires_grad_(False)
        return QCriticState(nets, targets, adam(nets.parameters(), self.critic_lr, mesh))

    # mixed-radix codecs (discrete_q_critic.py:149-217)
    def indiv_to_joint(self, actions) -> torch.Tensor:
        """Per-agent indices (…, 1) → joint indices (…, 1), int64."""
        joint, accum = torch.zeros_like(actions[0], dtype=torch.long), 1
        for a, dim in zip(actions, self.action_dims):
            joint = joint + accum * a.long()
            accum *= dim
        return joint

    def joint_to_indiv(self, joint: torch.Tensor):
        out, a = [], joint.long()
        for dim in self.action_dims:
            out.append(a % dim)
            a = a // dim
        return out

    def get_joint_idx(self, actions, agent_id: int) -> torch.Tensor:
        """(batch, n_agent_id) joint indices of every action of ``agent_id``
        with the other agents' actions held."""
        n_i = self.action_dims[agent_id]
        joint = torch.zeros((actions[0].shape[0], n_i), dtype=torch.long,
                            device=actions[0].device)
        accum = 1
        for i, dim in enumerate(self.action_dims):
            if i == agent_id:
                joint = joint + accum * torch.arange(n_i, device=joint.device)[None, :]
            else:
                joint = joint + accum * actions[i].long()
            accum *= dim
        return joint

    @staticmethod
    def q_all(nets: nn.ModuleList, share_obs: torch.Tensor) -> torch.Tensor:
        """Q of every joint action, (batch, ∏ nᵢ)."""
        return nets[0](share_obs)

    def get_values(self, state: QCriticState, share_obs, actions) -> torch.Tensor:
        return torch.take_along_dim(self.q_all(state.nets, share_obs),
                                    self.indiv_to_joint(actions), dim=-1)

    def train(self, state: QCriticState, sample, next_actions, mesh: Mesh = LOCAL,
              rows: Optional[int] = None) -> torch.Tensor:
        """One Adam step on mean (Q(s, a) − (r + γⁿ·Q′(s′, a′)·(1 − term)))²
        (``dones`` in place of ``terms`` without ``use_proper_time_limits``);
        ``next_actions`` are the agents' greedy target actions (…, 1).
        Updates ``state`` in place and returns the loss: this rank's sum
        over ``rows`` global rows (by default its own)."""
        with torch.no_grad():
            next_q = torch.take_along_dim(self.q_all(state.targets, sample.next_share_obs),
                                          self.indiv_to_joint(next_actions), dim=-1)
            not_end = 1.0 - (sample.terms if self.use_proper_time_limits else sample.dones)
            q_targets = sample.rewards + sample.gamma * next_q * not_end
        q = torch.take_along_dim(self.q_all(state.nets, sample.share_obs),
                                 self.indiv_to_joint(sample.actions), dim=-1)
        loss = (q - q_targets) ** 2
        loss = loss.sum() / (rows or loss.numel())
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        state.opt.step()
        return loss.detach()

    def soft_update_targets(self, state: QCriticState) -> None:
        soft_update(state.targets, state.nets, self.polyak)
