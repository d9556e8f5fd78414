"""Return / advantage computation (counterpart of ``harl_tpu/ops/returns.py``).

Callers pass *denormalized* value predictions. Time is axis 0, everything
else is batched. ``compute_gae`` and ``compute_discounted_returns`` dispatch
on the tensors' device through the wrappers of ``ops/gae_kernels.py``: the
CUDA kernel for CUDA tensors, the plain version for CPU tensors. The JAX
package's ``impl="assoc"`` prefix-scan form is not ported (ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from harl_tpu_torch.ops import gae_kernels


def compute_gae(rewards: torch.Tensor, values: torch.Tensor, masks: torch.Tensor,
                bad_masks: Optional[torch.Tensor], gamma: float,
                gae_lambda: float) -> torch.Tensor:
    """GAE returns (= gae + V), matching on_policy_critic_buffer_ep.py:107-139.

    rewards (T, …); values, masks, bad_masks (T+1, …); ``bad_masks=None``
    when proper time limits are off.
    """
    return gae_kernels.gae(
        rewards.contiguous(), values.contiguous(), masks.contiguous(),
        None if bad_masks is None else bad_masks.contiguous(), gamma, gae_lambda)


def compute_discounted_returns(rewards: torch.Tensor, values: torch.Tensor,
                               masks: torch.Tensor, bad_masks: Optional[torch.Tensor],
                               next_value: torch.Tensor, gamma: float) -> torch.Tensor:
    """ret_t = (ret_{t+1}·γ·m_{t+1} + r_t)·bad_{t+1} + (1−bad_{t+1})·V_t."""
    return gae_kernels.discounted_returns(
        rewards.contiguous(), values.contiguous(), masks.contiguous(),
        None if bad_masks is None else bad_masks.contiguous(),
        next_value.contiguous(), gamma)


def masked_mean_std(x: torch.Tensor, mask: torch.Tensor,
                    eps: float = 1e-9) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and population std (ddof=0, like np.nanstd) over mask≠0."""
    mask = torch.broadcast_to(mask, x.shape).to(x.dtype)
    denom = torch.clamp(mask.sum(), min=eps)
    mean = (x * mask).sum() / denom
    var = (((x - mean) ** 2) * mask).sum() / denom
    return mean, torch.sqrt(var)


def normalize_advantages_masked(advantages: torch.Tensor,
                                active_masks: torch.Tensor) -> torch.Tensor:
    """(adv − masked mean) / (masked std + 1e−5), applied to ALL elements,
    inactive ones included, like the reference (happo.py:122-127)."""
    mean, std = masked_mean_std(advantages, active_masks != 0)
    return (advantages - mean) / (std + 1e-5)
