"""MLP building blocks (counterpart of ``harl_tpu/models/mlp.py``).

``MLPBase``: optional input LayerNorm (use_feature_normalization), then
[Linear → activation → LayerNorm] per hidden layer, orthogonal weight init
with the activation's gain and zero bias (reference: harl/models/base/mlp.py).
The LayerNorms use eps=1e-6, flax's default, not torch's 1e-5.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

# flax.linen.LayerNorm's default epsilon, which the JAX package uses
LAYER_NORM_EPS = 1e-6

# torch.nn.init.calculate_gain equivalents (models_tools.py:28-60)
ACTIVATION_GAIN = {
    "sigmoid": 1.0,
    "tanh": 5.0 / 3.0,
    "relu": math.sqrt(2.0),
    "leaky_relu": math.sqrt(2.0 / (1.0 + 0.01 ** 2)),
    "selu": 3.0 / 4.0,
    "identity": 1.0,
}

ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": F.relu,
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "selu": F.selu,
    "identity": lambda x: x,
    "hardswish": F.hardswish,
}


def get_init(initialization_method: str, gain: float):
    """Weight initializer ``fn(weight, generator)`` (models_tools.py:38-60).

    Only orthogonal init is ported; the JAX package's other methods are on
    the roadmap. The port reproduces the init statistics, not the values.
    """
    if initialization_method == "orthogonal_":
        return lambda w, generator: nn.init.orthogonal_(w, gain=gain, generator=generator)
    raise NotImplementedError(
        f"initialization_method {initialization_method!r} is not ported yet "
        "(ROADMAP.md, options of the ported modules); use 'orthogonal_'")


def make_linear(in_dim: int, out_dim: int, init, device, generator) -> nn.Linear:
    """Linear layer with ``init`` on the weight and a zero bias."""
    layer = nn.Linear(in_dim, out_dim, device=device)
    with torch.no_grad():
        init(layer.weight, generator)
        layer.bias.zero_()
    return layer


class MLPBase(nn.Module):
    """Reference MLPBase (mlp.py:44-70): feature-norm + Linear/act/LayerNorm."""

    def __init__(self, in_dim: int, hidden_sizes: Sequence[int],
                 activation_func: str = "relu", use_feature_normalization: bool = True,
                 initialization_method: str = "orthogonal_",
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = ACTIVATIONS[activation_func]
        init = get_init(initialization_method, ACTIVATION_GAIN.get(activation_func, 1.0))
        self.feature_norm = (
            nn.LayerNorm(in_dim, eps=LAYER_NORM_EPS, device=device)
            if use_feature_normalization else None)
        dims = [in_dim, *hidden_sizes]
        self.fc = nn.ModuleList(
            make_linear(a, b, init, device, generator) for a, b in zip(dims[:-1], dims[1:]))
        self.ln = nn.ModuleList(
            nn.LayerNorm(h, eps=LAYER_NORM_EPS, device=device) for h in hidden_sizes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.feature_norm is not None:
            x = self.feature_norm(x)
        for fc, ln in zip(self.fc, self.ln):
            x = ln(self.act(fc(x)))
        return x
