"""HAPPO actor update (counterpart of ``harl_tpu/algos/happo.py``).

One ``update`` call is the reference ``HAPPO.train`` for one agent,
feed-forward path: EP advantage normalisation with the agent's active mask
(happo.py:122-127), ``ppo_epoch`` × ``actor_num_mini_batch`` minibatches,
the PPO-clip surrogate weighted by the HARL factor with active-mask
normalisation (happo.py:66-91), the entropy bonus and the clipped Adam step.
The recurrent paths are on the roadmap.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from harl_tpu_torch.algos.common import AgentTrainState, aggregate_ratio
from harl_tpu_torch.models.act import act_evaluate
from harl_tpu_torch.ops.returns import normalize_advantages_masked


class ActorBatch(NamedTuple):
    """One agent's rollout slice, time-major (T, B, ·)."""

    obs: torch.Tensor           # (T, B, obs_dim)
    actions: torch.Tensor       # (T, B, act_dim)
    logp: torch.Tensor          # (T, B, lp) — behavior log-probs from rollout
    active_masks: torch.Tensor  # (T, B, 1)


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + tuple(x.shape[2:]))


class HAPPOActor:
    """Binds the action space and config; the network and optimizer live in
    the ``AgentTrainState`` passed to ``update``."""

    def __init__(self, action_space, cfg: dict):
        if cfg.get("use_recurrent_policy") or cfg.get("use_naive_recurrent_policy"):
            raise NotImplementedError(
                "recurrent actor updates are not ported yet (ROADMAP.md, recurrent discrete path)")
        self.action_space = action_space
        self.clip_param = cfg.get("clip_param", 0.2)
        self.ppo_epoch = cfg["ppo_epoch"]
        self.num_mini_batch = cfg["actor_num_mini_batch"]
        self.entropy_coef = cfg["entropy_coef"]
        self.use_policy_active_masks = cfg.get("use_policy_active_masks", True)
        self.action_aggregation = cfg.get("action_aggregation", "prod")
        self.std_x_coef = cfg.get("std_x_coef", 1.0)
        self.std_y_coef = cfg.get("std_y_coef", 0.5)

    @torch.no_grad()
    def evaluate_logp(self, policy, batch: ActorBatch) -> torch.Tensor:
        """Full-batch log-probs of the stored actions, (T·B, lp)
        (on_policy_ha_runner.py:66-83,96-113)."""
        head = policy(_flat(batch.obs))
        ev = act_evaluate(head, self.action_space, _flat(batch.actions),
                          _flat(batch.active_masks), self.std_x_coef, self.std_y_coef)
        return ev.log_probs

    def update(self, state: AgentTrainState, batch: ActorBatch,
               advantages: torch.Tensor, factor: torch.Tensor,
               perms: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Train one agent in place. ``advantages`` and ``factor`` are
        (T, B, 1); ``perms`` (ppo_epoch, T·B) gives each epoch's shuffle and
        is needed only with more than one minibatch. Returns the mean over
        steps of [policy_loss, dist_entropy, grad_norm, ratio]."""
        T, B = batch.obs.shape[:2]
        advantages = normalize_advantages_masked(advantages, batch.active_masks)
        M = T * B
        data = [_flat(x) for x in (batch.obs, batch.actions, batch.logp,
                                   batch.active_masks, advantages, factor)]
        if self.num_mini_batch == 1:
            # a full-batch gradient does not depend on the order: no gather
            steps = [None] * self.ppo_epoch
        else:
            if perms is None or tuple(perms.shape) != (self.ppo_epoch, M):
                raise ValueError(f"need perms of shape {(self.ppo_epoch, M)}")
            steps = list(perms.reshape(self.ppo_epoch * self.num_mini_batch,
                                       M // self.num_mini_batch))
        stats = []
        for idx in steps:
            mb = data if idx is None else [x[idx] for x in data]
            policy_loss, entropy, ratio = self._loss(state.net, *mb)
            state.opt.zero_grad()
            (policy_loss - entropy * self.entropy_coef).backward()
            gnorm = state.opt.step()
            stats.append(torch.stack([policy_loss.detach(), entropy.detach(), gnorm,
                                      ratio.detach()]))
        return torch.stack(stats).mean(dim=0)

    def _loss(self, policy, obs, actions, old_logp, active, adv, fac):
        head = policy(obs)
        ev = act_evaluate(head, self.action_space, actions, active,
                          self.std_x_coef, self.std_y_coef)
        ratio = aggregate_ratio(ev.log_probs - old_logp, self.action_aggregation)
        surr1 = ratio * adv
        surr2 = torch.clamp(ratio, 1.0 - self.clip_param, 1.0 + self.clip_param) * adv
        obj = (fac * torch.minimum(surr1, surr2)).sum(dim=-1, keepdim=True)
        if self.use_policy_active_masks:
            policy_loss = -(obj * active).sum() / torch.clamp(active.sum(), min=1e-9)
        else:
            policy_loss = -obj.mean()
        return policy_loss, ev.entropy, ratio.mean()
