"""Centralized V-critic update (counterpart of ``harl_tpu/algos/critics.py``).

Clipped value loss with optional Huber and ValueNorm target normalisation
(v_critic.py:75-114), ``critic_epoch`` × ``critic_num_mini_batch``
minibatches, clipped Adam, loss scaled by ``value_loss_coef``. The ValueNorm
statistics are updated per minibatch *before* the loss is evaluated, the
reference's ordering (v_critic.py:93-96). Feed-forward path only.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from harl_tpu_torch.algos.common import AgentTrainState, huber_loss, mse_loss
from harl_tpu_torch.ops.value_norm import ValueNormState, normalize, update_value_norm


class CriticBatch(NamedTuple):
    """Critic rollout slice, time-major (T, B, ·) (EP state layout)."""

    share_obs: torch.Tensor    # (T, B, ds)
    value_preds: torch.Tensor  # (T, B, 1)
    returns: torch.Tensor      # (T, B, 1)


class VCritic:
    def __init__(self, cfg: dict):
        if cfg.get("use_recurrent_policy") or cfg.get("use_naive_recurrent_policy"):
            raise NotImplementedError(
                "recurrent critic updates are not ported yet (ROADMAP.md, recurrent discrete path)")
        self.clip_param = cfg["clip_param"]
        self.critic_epoch = cfg["critic_epoch"]
        self.num_mini_batch = cfg["critic_num_mini_batch"]
        self.value_loss_coef = cfg.get("value_loss_coef", 1.0)
        self.use_clipped_value_loss = cfg.get("use_clipped_value_loss", True)
        self.use_huber_loss = cfg.get("use_huber_loss", True)
        self.huber_delta = cfg.get("huber_delta", 10.0)

    def value_loss(self, values, value_preds, returns,
                   vn: Optional[ValueNormState]) -> torch.Tensor:
        """cal_value_loss (v_critic.py:75-114); ``vn`` already updated."""
        clipped = value_preds + torch.clamp(values - value_preds,
                                            -self.clip_param, self.clip_param)
        target = normalize(vn, returns) if vn is not None else returns
        err_clipped = target - clipped
        err_orig = target - values
        if self.use_huber_loss:
            l_clipped = huber_loss(err_clipped, self.huber_delta)
            l_orig = huber_loss(err_orig, self.huber_delta)
        else:
            l_clipped = mse_loss(err_clipped)
            l_orig = mse_loss(err_orig)
        loss = torch.maximum(l_orig, l_clipped) if self.use_clipped_value_loss else l_orig
        return loss.mean()

    def update(self, state: AgentTrainState, vn: Optional[ValueNormState],
               batch: CriticBatch, perms: Optional[torch.Tensor] = None
               ) -> Tuple[Optional[ValueNormState], torch.Tensor]:
        """Train the critic in place; returns (new ValueNorm state,
        [value_loss, grad_norm] averaged over steps). ``perms``
        (critic_epoch, T·B) is needed only with more than one minibatch."""
        T, B = batch.share_obs.shape[:2]
        M = T * B
        data = [x.reshape((M,) + tuple(x.shape[2:]))
                for x in (batch.share_obs, batch.value_preds, batch.returns)]
        if self.num_mini_batch == 1:
            steps = [None] * self.critic_epoch
        else:
            if perms is None or tuple(perms.shape) != (self.critic_epoch, M):
                raise ValueError(f"need perms of shape {(self.critic_epoch, M)}")
            steps = list(perms.reshape(self.critic_epoch * self.num_mini_batch,
                                       M // self.num_mini_batch))
        stats = []
        for idx in steps:
            share_obs, value_preds, returns = (
                data if idx is None else [x[idx] for x in data])
            if vn is not None:
                vn = update_value_norm(vn, returns)
            loss = self.value_loss(state.net(share_obs), value_preds, returns, vn)
            state.opt.zero_grad()
            (loss * self.value_loss_coef).backward()
            gnorm = state.opt.step()
            stats.append(torch.stack([loss.detach(), gnorm]))
        return vn, torch.stack(stats).mean(dim=0)
