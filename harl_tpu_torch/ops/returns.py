"""Return / advantage computation (counterpart of ``harl_tpu/ops/returns.py``).

Callers pass *denormalized* value predictions. Time is axis 0, everything
else is batched: (T, B, 1) under the EP state, (T, B, N, 1) per agent under
FP, which the kernels see as B·N columns. ``compute_gae`` and
``compute_discounted_returns`` dispatch
on the tensors' device through the wrappers of ``ops/gae_kernels.py``: the
CUDA kernel for CUDA tensors, the plain version for CPU tensors. A caller
that names ``impl="assoc"`` gets the JAX package's log-depth form instead,
on any device: the recursion x_t = a_t·x_{t+1} + b_t as a Hillis–Steele
prefix scan of affine maps over T, in ⌈log₂ T⌉ steps of whole-tensor ops.
The runners never name it.

The masked mean and std are the global ones over every rank's rows of a
data-parallel ``mesh`` (``parallel/mesh.py``; one rank by default).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from harl_tpu_torch.ops import gae_kernels
from harl_tpu_torch.parallel.mesh import LOCAL, Mesh


def affine_scan_reverse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x_t = a_t·x_{t+1} + b_t over axis 0 with x_T = 0: the maps composed
    by a Hillis–Steele scan over the time-reversed sequence (the JAX
    package's ``associative_scan`` with the same combine, another tree)."""
    a, b = torch.flip(a, (0,)), torch.flip(b, (0,))
    d = 1
    while d < a.shape[0]:
        # element s absorbs the prefix ending at s − d: (a', b') ∘ (a, b)
        b = torch.cat([b[:d], a[d:] * b[:-d] + b[d:]])
        a = torch.cat([a[:d], a[:-d] * a[d:]])
        d *= 2
    return torch.flip(b, (0,))


def compute_gae(rewards: torch.Tensor, values: torch.Tensor, masks: torch.Tensor,
                bad_masks: Optional[torch.Tensor], gamma: float,
                gae_lambda: float, impl: Optional[str] = None) -> torch.Tensor:
    """GAE returns (= gae + V), matching on_policy_critic_buffer_ep.py:107-139.

    rewards (T, …); values, masks, bad_masks (T+1, …); ``bad_masks=None``
    when proper time limits are off. ``impl="assoc"``: the log-depth scan
    (JAX ``ops/returns.py:42-65``).
    """
    if impl == "assoc":
        m_next = masks[1:]
        bm = torch.ones_like(m_next) if bad_masks is None else bad_masks[1:]
        deltas = rewards + gamma * values[1:] * m_next - values[:-1]
        return affine_scan_reverse((gamma * gae_lambda) * m_next * bm, bm * deltas) + values[:-1]
    _check_impl(impl)
    return gae_kernels.gae(
        rewards.contiguous(), values.contiguous(), masks.contiguous(),
        None if bad_masks is None else bad_masks.contiguous(), gamma, gae_lambda)


def compute_discounted_returns(rewards: torch.Tensor, values: torch.Tensor,
                               masks: torch.Tensor, bad_masks: Optional[torch.Tensor],
                               next_value: torch.Tensor, gamma: float,
                               impl: Optional[str] = None) -> torch.Tensor:
    """ret_t = (ret_{t+1}·γ·m_{t+1} + r_t)·bad_{t+1} + (1−bad_{t+1})·V_t;
    ``impl="assoc"``: the log-depth scan, the bootstrap folded into the last
    step (JAX ``ops/returns.py:100-118``)."""
    if impl == "assoc":
        m_next = masks[1:]
        bm = torch.ones_like(m_next) if bad_masks is None else bad_masks[1:]
        a = gamma * m_next * bm
        b = rewards * bm + (1.0 - bm) * values[:-1]
        b = torch.cat([b[:-1], (b[-1] + a[-1] * next_value)[None]])
        return affine_scan_reverse(a, b)
    _check_impl(impl)
    return gae_kernels.discounted_returns(
        rewards.contiguous(), values.contiguous(), masks.contiguous(),
        None if bad_masks is None else bad_masks.contiguous(),
        next_value.contiguous(), gamma)


def _check_impl(impl: Optional[str]) -> None:
    if impl is not None:
        raise ValueError(f"impl {impl!r}: expected None (the kernel) or 'assoc'")


def masked_mean_std(x: torch.Tensor, mask: torch.Tensor, eps: float = 1e-9,
                    mesh: Mesh = LOCAL) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and population std (ddof=0, like np.nanstd) over mask≠0 of
    every rank's rows (two passes, one all-reduce each).

    The sums run in float64 and the results round back to ``x``'s dtype:
    the order of the sums (a rank's rows, then the all-reduce over the
    ranks) moves them far less than a float32 ulp, so W ranks round to
    the one-rank run's values."""
    x64 = x.double()
    mask = torch.broadcast_to(mask, x.shape).to(torch.float64)
    total, count = mesh.all_reduce_sum([(x64 * mask).sum(), mask.sum()])
    denom = torch.clamp(count, min=eps)
    mean = total / denom
    (sq,) = mesh.all_reduce_sum([(((x64 - mean) ** 2) * mask).sum()])
    return mean.to(x.dtype), torch.sqrt(sq / denom).to(x.dtype)


def normalize_advantages_masked(advantages: torch.Tensor, active_masks: torch.Tensor,
                                mesh: Mesh = LOCAL) -> torch.Tensor:
    """(adv − masked mean) / (masked std + 1e−5), applied to ALL elements,
    inactive ones included, like the reference (happo.py:122-127)."""
    mean, std = masked_mean_std(advantages, active_masks != 0, mesh=mesh)
    return (advantages - mean) / (std + 1e-5)
