"""HATRPO: the trust-region actor update with the HARL factor (counterpart of
``harl_tpu/algos/hatrpo.py``; reference ``harl/algorithms/actors/hatrpo.py``
and ``harl/utils/trpo_util.py``).

One full-batch update per iteration, no optimizer:

  * surrogate  L(θ) = Σ ratio·factor·adv·active / Σ active      (hatrpo.py:77-90)
  * g = ∇L, flattened with ``parameters_to_vector`` (the order of
    ``net.parameters()``; only the summation order of dot products differs
    from ``ravel_pytree``'s)
  * conjugate gradient (10 steps, stopping early once r·r ≤ 1e−10) solves
    (H + 0.1 I) x = g, H the Hessian of the mean KL(old ‖ new) at the current
    parameters. The Fisher-vector products are reverse-over-reverse, the
    reference's own form (trpo_util.py:132-158): the KL's gradient is taken
    once with ``create_graph=True``, and each product differentiates its dot
    with v. Every op on the path has a double backward, the hand-written GRU
    cell (``models/rnn.py``) and LayerNorm included.
  * step = x / √(x·(H + 0.1 I)x / (2·kl_threshold))               (hatrpo.py:113-121)
  * backtracking line search, at most ``ls_step`` tries: the candidate
    θ + f·step is accepted when KL < kl_threshold, improvement > 0 and
    improvement / expected > accept_ratio (a NaN ratio does not accept);
    f and the expected improvement shrink by ``backtrack_coeff`` after each
    refusal, in float32 as the JAX loop carries them. The first accepted
    candidate is kept; if none is, the parameters stay as they were.

The CG's stopping test and each line-search decision read one scalar on the
host: at most 10 + 10 reads an agent, as the reference does. With a
``utils.profiling.PhaseTimer`` in ``timer``, the update's phases are timed:
"gradient" (forward, surrogate gradient, the KL's gradient graph), "cg"
(the conjugate gradient with its FVPs, and the step's scale) and
"line_search".

A recurrent policy runs the whole rollout in sequence mode from
``rnn_states[0]``, ignoring ``data_chunk_length`` (hatrpo.py:93-104). KL
forms: ``kl_approx`` on the raw head logits for Discrete (trpo_util.py:47-52),
the diagonal-normal KL with ``diag_gaussian_std`` for Box (:55-62).
MultiDiscrete is unsupported, as in the reference (hatrpo.py:27-29).

An update runs on a rank's ``share`` of the env columns (``Share``,
``parallel/mesh.py``; all of them on one rank by default): the surrogate
and the KL are its sums over the global counts,
and the surrogate's gradient (with the reported stats), every Fisher-vector
product and each try's surrogate and KL are summed over the ranks in one
all-reduce each. CG then runs on replicated vectors, and every rank takes
the same line-search branch.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
from torch.nn.utils import parameters_to_vector

from harl_tpu_torch.algos.common import AgentTrainState, Share, aggregate_ratio, flat
from harl_tpu_torch.algos.happo import ActorBatch, HAPPOActor
from harl_tpu_torch.models.act import act_evaluate
from harl_tpu_torch.ops import distributions as D
from harl_tpu_torch.ops.returns import normalize_advantages_masked
from harl_tpu_torch.utils import spaces

CG_STEPS = 10
CG_RESIDUAL_TOL = 1e-10
FVP_DAMPING = 0.1


def _flat_grad(out: torch.Tensor, params: List[torch.Tensor], **kw) -> torch.Tensor:
    """∂out/∂params as one vector, zeros for parameters ``out`` does not reach."""
    grads = torch.autograd.grad(out, params, allow_unused=True, **kw)
    return torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                      for g, p in zip(grads, params)])


@torch.no_grad()
def _assign(params: List[torch.Tensor], vec: torch.Tensor) -> None:
    """Copy ``vec`` into the parameters in place (storage unchanged)."""
    offset = 0
    for p in params:
        n = p.numel()
        p.copy_(vec[offset: offset + n].view_as(p))
        offset += n


class HATRPOActor(HAPPOActor):
    """Trust-region variant of the HAPPO actor; the Adam of its
    ``AgentTrainState`` is never stepped. After ``update``,
    ``last_fraction`` holds the accepted step fraction (0.0 when the line
    search accepted none), ``last_tries`` each try's (kl, improvement,
    expected improvement), as tensors, and ``last_fvps`` the Fisher-vector
    products taken."""

    def __init__(self, action_space, cfg: dict):
        if spaces.space_kind(action_space) == "MultiDiscrete":
            raise ValueError("only continuous and discrete action spaces are supported by HATRPO")
        cfg = dict(cfg)
        cfg.setdefault("ppo_epoch", 1)
        cfg.setdefault("actor_num_mini_batch", 1)
        cfg.setdefault("entropy_coef", 0.0)
        super().__init__(action_space, cfg)
        self.kl_threshold = cfg["kl_threshold"]
        self.ls_step = cfg["ls_step"]
        self.accept_ratio = cfg["accept_ratio"]
        self.backtrack_coeff = cfg["backtrack_coeff"]
        self.last_fraction = 0.0
        self.last_tries = []
        self.last_fvps = 0
        self.timer = None   # a PhaseTimer, to time the update's phases

    def _phase(self, name: str):
        return self.timer.phase(name) if self.timer is not None else contextlib.nullcontext()

    def _kl(self, new_head, old_head, count: int) -> torch.Tensor:
        """Mean over rows of the reference KL forms summed over action dims:
        the sum over a rank's rows divided by ``count``, the global rows."""
        if spaces.space_kind(self.action_space) == "Discrete":
            p, q = old_head[0], new_head[0]
            kl = torch.exp(q - p) - 1.0 - q + p
        else:
            (mean_p, log_std_p), (mean_q, log_std_q) = old_head, new_head
            std_p = D.diag_gaussian_std(log_std_p, self.std_x_coef, self.std_y_coef)
            std_q = D.diag_gaussian_std(log_std_q, self.std_x_coef, self.std_y_coef)
            var_ratio = (std_p / std_q) ** 2
            t1 = ((mean_p - mean_q) / std_q) ** 2
            kl = 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))
        return kl.sum() / count

    def update(self, state: AgentTrainState, batch: ActorBatch, advantages: torch.Tensor,
               factor: torch.Tensor, perms: Optional[torch.Tensor] = None,
               state_type: str = "EP", share: Optional[Share] = None) -> torch.Tensor:
        """Train one agent in place; ``perms`` is unused (one full batch).
        ``share`` defaults to every column. Returns [improvement, entropy,
        kl, ratio], the first and third 0 when no step was accepted."""
        del perms
        share = share or Share.whole(batch.obs.shape[1])
        mesh = share.mesh
        if state_type == "EP":
            advantages = normalize_advantages_masked(advantages, batch.active_masks, mesh)
        net = state.net
        params = list(net.parameters())
        actions, old_logp, active, avail, adv, fac = map(flat, (
            batch.actions, batch.logp, batch.active_masks, batch.available_actions,
            advantages, factor))
        count = actions.shape[0] // len(share.cols) * share.total
        (denom,) = mesh.all_reduce_sum([active.sum()])

        def reduce(*xs):
            return tuple(mesh.all_reduce_sum(xs))

        def forward():
            """Full-batch heads, rows flattened to (T·B, ·)."""
            if self.chunking.use_rnn:
                head, _ = net(batch.obs, batch.rnn_states[0], batch.masks, seq=True)
                return tuple(flat(h) for h in head)
            return net(flat(batch.obs))[0]

        def surrogate(head):
            ev = act_evaluate(head, self.action_space, actions, avail, active,
                              self.std_x_coef, self.std_y_coef, entropy_denom=denom)
            ratio = aggregate_ratio(ev.log_probs - old_logp, self.action_aggregation)
            obj = (ratio * fac * adv).sum(dim=-1, keepdim=True)
            if self.use_policy_active_masks:
                loss = (obj * active).sum() / torch.clamp(denom, min=1e-9)
            else:
                loss = obj.sum() / count
            return loss, ev.entropy, ratio.sum() / count

        with self._phase("gradient"):
            head = forward()
            loss0, entropy, ratio_mean = surrogate(head)
            g = _flat_grad(loss0, params, retain_graph=True).detach()
            g, loss0, entropy, ratio_mean = reduce(g, loss0.detach(), entropy.detach(),
                                                   ratio_mean.detach())
            # cloned: a Box head's log_std is a view of the parameter, which
            # the line search overwrites in place
            old_head = tuple(h.detach().clone() for h in head)
            kl_grad = _flat_grad(self._kl(head, old_head, count), params, create_graph=True)
        self.last_fvps = 0

        def fvp(v: torch.Tensor) -> torch.Tensor:
            """(H_kl + damping·I)·v."""
            self.last_fvps += 1
            (hv,) = reduce(_flat_grad(kl_grad @ v, params, retain_graph=True))
            return hv + FVP_DAMPING * v

        with self._phase("cg"):
            # conjugate gradient (trpo_util.py:96-129)
            x = torch.zeros_like(g)
            r, p = g.clone(), g.clone()
            rdotr = r @ r
            for _ in range(CG_STEPS):
                if not bool(rdotr > CG_RESIDUAL_TOL):
                    break
                avp = fvp(p)
                alpha = rdotr / (p @ avp)
                x = x + alpha * p
                r = r - alpha * avp
                new_rdotr = r @ r
                p = r + (new_rdotr / rdotr) * p
                rdotr = new_rdotr

            shs = 0.5 * (x @ fvp(x))
            step_size = 1.0 / torch.sqrt(torch.clamp(shs / self.kl_threshold, min=1e-16))
            full_step = step_size * x
            expected = g @ full_step
        del kl_grad

        # backtracking line search (hatrpo.py:134-192)
        params_flat = parameters_to_vector(params).detach()
        fraction = torch.ones((), device=g.device)
        kl_out = improve_out = torch.zeros((), device=g.device)
        self.last_fraction, self.last_tries = 0.0, []
        with torch.no_grad(), self._phase("line_search"):
            for _ in range(self.ls_step):
                _assign(params, params_flat + fraction * full_step)
                head = forward()
                new_loss, kl = reduce(surrogate(head)[0], self._kl(head, old_head, count))
                improve = new_loss - loss0
                self.last_tries.append((kl, improve, expected))
                ok = (kl < self.kl_threshold) & (improve / expected > self.accept_ratio) & (
                    improve > 0)
                if bool(ok):
                    kl_out, improve_out = kl, improve
                    self.last_fraction = float(fraction)
                    break
                fraction = fraction * self.backtrack_coeff
                expected = expected * self.backtrack_coeff
            else:
                _assign(params, params_flat)   # rollback: nothing accepted
        return torch.stack([improve_out, entropy, kl_out, ratio_mean])
