"""Centralized V-critic update (counterpart of ``harl_tpu/algos/critics.py``).

Clipped value loss with optional Huber and ValueNorm target normalisation
(v_critic.py:75-114), ``critic_epoch`` × ``critic_num_mini_batch``
minibatches, clipped Adam, loss scaled by ``value_loss_coef``. The ValueNorm
statistics are updated per minibatch *before* the loss is evaluated, the
reference's ordering (v_critic.py:93-96). A recurrent critic uses the actor's
chunked-BPTT rows (``algos/common.py:Chunking``); under the FP state the batch
axis is env × agent. An update runs on a rank's ``share`` of the columns
(every column on one rank by default), training on its rows of each global
minibatch: the ValueNorm moments are global, the loss is the rank's sum over
the global count, and the optimizer sums the gradients over the ranks.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from harl_tpu_torch.algos.common import (AgentTrainState, Chunking, Share, huber_loss,
                                         mse_loss, time_major)
from harl_tpu_torch.ops.value_norm import ValueNormState, normalize, update_value_norm


class CriticBatch(NamedTuple):
    """Critic rollout slice, time-major (T, B, ·); B is B·N under FP."""

    share_obs: torch.Tensor    # (T, B, ds)
    value_preds: torch.Tensor  # (T, B, 1)
    returns: torch.Tensor      # (T, B, 1)
    rnn_states: Optional[torch.Tensor] = None  # (T, B, recurrent_n, H) at step input
    masks: Optional[torch.Tensor] = None       # (T, B, 1)


class VCritic:
    def __init__(self, cfg: dict):
        self.clip_param = cfg["clip_param"]
        self.critic_epoch = cfg["critic_epoch"]
        self.num_mini_batch = cfg["critic_num_mini_batch"]
        self.value_loss_coef = cfg.get("value_loss_coef", 1.0)
        self.use_clipped_value_loss = cfg.get("use_clipped_value_loss", True)
        self.use_huber_loss = cfg.get("use_huber_loss", True)
        self.huber_delta = cfg.get("huber_delta", 10.0)
        self.chunking = Chunking(cfg)

    def value_loss(self, values, value_preds, returns,
                   vn: Optional[ValueNormState], count=None) -> torch.Tensor:
        """cal_value_loss (v_critic.py:75-114); ``vn`` already updated. The
        sum over the rows divided by ``count`` (a rank's share: the global
        count), by default their number."""
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
        return loss.sum() / (loss.numel() if count is None else count)

    def update(self, state: AgentTrainState, vn: Optional[ValueNormState],
               batch: CriticBatch, perms: Optional[torch.Tensor] = None,
               share: Optional[Share] = None
               ) -> Tuple[Optional[ValueNormState], torch.Tensor]:
        """Train the critic in place; returns (new ValueNorm state,
        [value_loss, grad_norm] averaged over steps). ``perms``
        (critic_epoch, global rows) is needed only with more than one
        minibatch; ``share`` defaults to every column."""
        T, B = batch.share_obs.shape[:2]
        ch = self.chunking
        share = share or Share.whole(B)
        mesh = share.mesh
        data = [ch.prep(x, T) for x in (batch.share_obs, batch.value_preds, batch.returns,
                                        batch.masks if ch.use_rnn else None)]
        rnn0 = ch.first_states(batch.rnn_states, T) if ch.use_rnn else None
        stats = []
        for idx, count in ch.steps(self.critic_epoch, self.num_mini_batch, T, share, perms,
                                   batch.share_obs.device):
            share_obs, value_preds, returns, masks = (
                data if idx is None else [None if x is None else x[idx] for x in data])
            if vn is not None:
                vn = update_value_norm(vn, returns, mesh=mesh)
            if rnn0 is not None:
                h0 = rnn0 if idx is None else rnn0[idx]
                values, _ = state.net(time_major(share_obs), h0, time_major(masks), seq=True)
                value_preds, returns = time_major(value_preds), time_major(returns)
            else:
                values, _ = state.net(share_obs)
            loss = self.value_loss(values, value_preds, returns, vn, count)
            state.opt.zero_grad()
            (loss * self.value_loss_coef).backward()
            gnorm = state.opt.step()
            stats.append(torch.stack([loss.detach(), gnorm]))
        stats = torch.stack(stats).mean(dim=0)
        (loss_sum,) = mesh.all_reduce_sum([stats[0]])
        return vn, torch.stack([loss_sum, stats[1]])
