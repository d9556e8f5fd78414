"""Running return normalizer (counterpart of ``harl_tpu/ops/value_norm.py``).

Debiased EMA of mean and mean-square with β=0.99999, variance clamped to
≥1e−2 and the debiasing term clamped to ≥ε (reference: valuenorm.py). The
state is a small dataclass of tensors; every function returns a new state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from harl_tpu_torch.parallel.mesh import LOCAL, Mesh


@dataclasses.dataclass
class ValueNormState:
    running_mean: torch.Tensor     # (input_shape,)
    running_mean_sq: torch.Tensor  # (input_shape,)
    debiasing_term: torch.Tensor   # ()


def init_value_norm(input_shape=1, device=None, dtype=torch.float32) -> ValueNormState:
    shape = (input_shape,) if isinstance(input_shape, int) else tuple(input_shape)
    return ValueNormState(
        running_mean=torch.zeros(shape, dtype=dtype, device=device),
        running_mean_sq=torch.zeros(shape, dtype=dtype, device=device),
        debiasing_term=torch.zeros((), dtype=dtype, device=device),
    )


def _debiased_mean_var(state: ValueNormState,
                       epsilon: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """valuenorm.py:44-52 — clamp debias by ε, clamp var to ≥1e−2."""
    debias = torch.clamp(state.debiasing_term, min=epsilon)
    mean = state.running_mean / debias
    mean_sq = state.running_mean_sq / debias
    var = torch.clamp(mean_sq - mean ** 2, min=1e-2)
    return mean, var


@torch.no_grad()
def update_value_norm(state: ValueNormState, input_vector: torch.Tensor,
                      beta: float = 0.99999, per_element_update: bool = False,
                      mesh: Mesh = LOCAL) -> ValueNormState:
    """EMA update over all leading axes (valuenorm.py:54-75). With
    ``per_element_update`` the weight is β to the power of the rows
    averaged. Each rank of a data-parallel ``mesh`` (``parallel/mesh.py``;
    one rank by default) holds some of the rows: the moments and the row
    count are the global ones, summed over the ranks in one all-reduce."""
    axes = tuple(range(input_vector.dim() - state.running_mean.dim()))
    count = torch.tensor(float(math.prod(input_vector.shape[a] for a in axes)),
                         dtype=input_vector.dtype, device=input_vector.device)
    total, total_sq, count = mesh.all_reduce_sum([
        input_vector.sum(dim=axes), (input_vector ** 2).sum(dim=axes), count])
    batch_mean, batch_sq_mean = total / count, total_sq / count
    weight, rest = beta, 1.0 - beta
    if per_element_update:
        # β^n and 1 − β^n in float64, as the JAX package's Python floats
        w = beta ** count.double()
        weight, rest = w.to(count.dtype), (1.0 - w).to(count.dtype)
    return ValueNormState(
        running_mean=state.running_mean * weight + batch_mean * rest,
        running_mean_sq=state.running_mean_sq * weight + batch_sq_mean * rest,
        debiasing_term=state.debiasing_term * weight + rest,
    )


def normalize(state: ValueNormState, x: torch.Tensor) -> torch.Tensor:
    mean, var = _debiased_mean_var(state)
    return (x - mean) / torch.sqrt(var)


def denormalize(state: ValueNormState, x: torch.Tensor) -> torch.Tensor:
    mean, var = _debiased_mean_var(state)
    return x * torch.sqrt(var) + mean
