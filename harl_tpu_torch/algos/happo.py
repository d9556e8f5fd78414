"""HAPPO, HAA2C and MAPPO actor updates (counterpart of
``harl_tpu/algos/happo.py``).

One ``update`` call is the reference ``HAPPO.train`` for one agent: EP
advantage normalisation with the agent's active mask (happo.py:122-127; under
FP the runner has normalised once across agents), ``ppo_epoch`` ×
``actor_num_mini_batch`` minibatches, the PPO-clip surrogate weighted by the
HARL factor with active-mask normalisation (happo.py:66-91), the entropy
bonus and the clipped Adam step.

Minibatch rows: feed-forward, the T·B steps; recurrent, chunks of
``data_chunk_length`` L steps (chunked BPTT, recurrent_generator_actor): the
(T, B, ·) batch is cut per env into C = B·T/L chunks, each run through the GRU
in sequence mode from the hidden state the rollout stored at its first step.
The naive-recurrent path is the L = T case (whole env threads).

An update runs on a rank's ``share`` of the env columns (``Share``,
``parallel/mesh.py``; all of them on one rank by default): the
advantages' statistics are global, each minibatch is the rank's rows of the
global minibatch (maybe none), every masked mean is the rank's sum over the
global denominator, the optimizer sums the gradients over the ranks, and
the returned stats are global.

HAA2C drops the clip and takes its epochs from ``a2c_epoch`` (haa2c.py:64-82);
MAPPO is HAPPO's loss, and its runner passes an all-ones factor and skips
the factor chain (mappo.py:64-80).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from harl_tpu_torch.algos.common import (AgentTrainState, Chunking, Share, aggregate_ratio,
                                         flat, time_major)
from harl_tpu_torch.models.act import act_evaluate
from harl_tpu_torch.ops.returns import normalize_advantages_masked


class ActorBatch(NamedTuple):
    """One agent's rollout slice, time-major (T, B, ·)."""

    obs: torch.Tensor           # (T, B, obs_dim)
    actions: torch.Tensor       # (T, B, act_dim)
    logp: torch.Tensor          # (T, B, lp) — behavior log-probs from rollout
    active_masks: torch.Tensor  # (T, B, 1)
    rnn_states: Optional[torch.Tensor] = None         # (T, B, recurrent_n, H) at step input
    masks: Optional[torch.Tensor] = None              # (T, B, 1)
    available_actions: Optional[torch.Tensor] = None  # (T, B, n_actions)


class HAPPOActor:
    """Binds the action space and config; the network and optimizer live in
    the ``AgentTrainState`` passed to ``update``."""

    use_clip = True          # HAA2C: the unclipped surrogate
    epoch_key = "ppo_epoch"  # HAA2C: "a2c_epoch"

    def __init__(self, action_space, cfg: dict):
        self.action_space = action_space
        self.clip_param = cfg.get("clip_param", 0.2)
        self.ppo_epoch = cfg[self.epoch_key]
        self.num_mini_batch = cfg["actor_num_mini_batch"]
        self.entropy_coef = cfg["entropy_coef"]
        self.use_policy_active_masks = cfg.get("use_policy_active_masks", True)
        self.action_aggregation = cfg.get("action_aggregation", "prod")
        self.std_x_coef = cfg.get("std_x_coef", 1.0)
        self.std_y_coef = cfg.get("std_y_coef", 0.5)
        self.chunking = Chunking(cfg)

    @torch.no_grad()
    def evaluate_logp(self, policy, batch: ActorBatch) -> torch.Tensor:
        """Full-batch log-probs of the stored actions, (T·B, lp)
        (on_policy_ha_runner.py:66-83,96-113). A recurrent policy runs the
        whole rollout in sequence mode from ``rnn_states[0]``."""
        if self.chunking.use_rnn:
            head, _ = policy(batch.obs, batch.rnn_states[0], batch.masks, seq=True)
            ev = act_evaluate(head, self.action_space, batch.actions, batch.available_actions,
                              batch.active_masks, self.std_x_coef, self.std_y_coef)
            return flat(ev.log_probs)
        head, _ = policy(flat(batch.obs))
        ev = act_evaluate(head, self.action_space, flat(batch.actions),
                          flat(batch.available_actions), flat(batch.active_masks),
                          self.std_x_coef, self.std_y_coef)
        return ev.log_probs

    def update(self, state: AgentTrainState, batch: ActorBatch,
               advantages: torch.Tensor, factor: torch.Tensor,
               perms: Optional[torch.Tensor] = None, state_type: str = "EP",
               share: Optional[Share] = None) -> torch.Tensor:
        """Train one agent in place. ``advantages`` and ``factor`` are
        (T, B, 1); ``perms`` (ppo_epoch, rows) gives each epoch's shuffle of
        the global minibatch rows (``chunking.rows``) and is needed only
        with more than one minibatch; ``share`` defaults to every column.
        Returns the mean over steps of [policy_loss, dist_entropy,
        grad_norm, ratio]."""
        T, B = batch.obs.shape[:2]
        ch = self.chunking
        share = share or Share.whole(B)
        mesh = share.mesh
        if state_type == "EP":
            advantages = normalize_advantages_masked(advantages, batch.active_masks, mesh)
        data = [ch.prep(x, T) for x in (batch.obs, batch.actions, batch.logp,
                                        batch.active_masks, advantages, factor,
                                        batch.masks if ch.use_rnn else None,
                                        batch.available_actions)]
        rnn0 = ch.first_states(batch.rnn_states, T) if ch.use_rnn else None
        steps = ch.steps(self.ppo_epoch, self.num_mini_batch, T, share, perms,
                         batch.obs.device)
        # every step's global active count, in one all-reduce
        (denoms,) = mesh.all_reduce_sum([torch.stack([
            (data[3] if idx is None else data[3][idx]).sum() for idx, _ in steps])])
        stats = []
        for (idx, count), denom in zip(steps, denoms):
            mb = data if idx is None else [None if x is None else x[idx] for x in data]
            h0 = rnn0 if idx is None or rnn0 is None else rnn0[idx]
            policy_loss, entropy, ratio = self._loss(state.net, h0, *mb, denom=denom,
                                                     count=count)
            state.opt.zero_grad()
            (policy_loss - entropy * self.entropy_coef).backward()
            gnorm = state.opt.step()
            stats.append(torch.stack([policy_loss.detach(), entropy.detach(), gnorm,
                                      ratio.detach()]))
        stats = torch.stack(stats).mean(dim=0)
        # the ranks' shares of the loss, entropy and ratio add up
        (summed,) = mesh.all_reduce_sum([stats[[0, 1, 3]]])
        return torch.stack([summed[0], summed[1], stats[2], summed[2]])

    def _loss(self, policy, rnn0, obs, actions, old_logp, active, adv, fac, masks, avail,
              denom, count):
        """(policy loss, entropy, mean ratio) of a rank's rows of a
        minibatch: its sums over ``denom`` (the global active count) and
        ``count`` (the global time steps)."""
        if rnn0 is not None:
            # (mb, L, …) → time-major (L, mb, …) for the GRU's sequence mode
            head, _ = policy(time_major(obs), rnn0, time_major(masks), seq=True)
            actions, old_logp, active, adv, fac, avail = map(
                time_major, (actions, old_logp, active, adv, fac, avail))
        else:
            head, _ = policy(obs)
        ev = act_evaluate(head, self.action_space, actions, avail, active,
                          self.std_x_coef, self.std_y_coef, entropy_denom=denom)
        ratio = aggregate_ratio(ev.log_probs - old_logp, self.action_aggregation)
        surr = ratio * adv
        if self.use_clip:
            surr = torch.minimum(
                surr, torch.clamp(ratio, 1.0 - self.clip_param, 1.0 + self.clip_param) * adv)
        obj = (fac * surr).sum(dim=-1, keepdim=True)
        if self.use_policy_active_masks:
            policy_loss = -(obj * active).sum() / torch.clamp(denom, min=1e-9)
        else:
            policy_loss = -obj.sum() / count
        return policy_loss, ev.entropy, ratio.sum() / count


class HAA2CActor(HAPPOActor):
    """HAA2C: the unclipped factor-weighted surrogate; epochs from ``a2c_epoch``."""

    use_clip = False
    epoch_key = "a2c_epoch"


class MAPPOActor(HAPPOActor):
    """MAPPO: HAPPO's loss; the runner passes an all-ones factor and skips the
    factor chain (on_policy_ma_runner.py)."""
