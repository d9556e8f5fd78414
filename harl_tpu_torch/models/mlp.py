"""MLP building blocks (counterpart of ``harl_tpu/models/mlp.py``).

``MLPBase``: optional input LayerNorm (use_feature_normalization), then
[Linear → activation → LayerNorm] per hidden layer, orthogonal weight init
with the activation's gain and zero bias (reference: harl/models/base/mlp.py).
The LayerNorms use eps=1e-6, flax's default, not torch's 1e-5.

``PlainMLP``: [Linear → activation] stacks without LayerNorm, the last
layer with its own activation (reference: harl/models/base/plain_mlp.py),
for the off-policy networks. Its layers take flax ``Dense``'s default init,
LeCun normal truncated at two standard deviations with a zero bias.
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

    ``orthogonal_`` scales by ``gain``; the other four are flax's
    ``xavier_uniform``, ``xavier_normal``, ``he_uniform`` and ``he_normal``,
    which the JAX package uses and which ignore ``gain``. The port
    reproduces the init statistics, not the values.
    """
    if initialization_method == "orthogonal_":
        return lambda w, generator: nn.init.orthogonal_(w, gain=gain, generator=generator)
    if initialization_method not in VARIANCE_SCALING:
        raise ValueError(f"Unknown initialization method {initialization_method}")
    scale, mode, distribution = VARIANCE_SCALING[initialization_method]
    return lambda w, generator: variance_scaling_(w, scale, mode, distribution, generator)


# flax's initializers as variance_scaling(scale, mode, distribution)
VARIANCE_SCALING = {
    "xavier_uniform_": (1.0, "fan_avg", "uniform"),
    "xavier_normal_": (1.0, "fan_avg", "truncated_normal"),
    "kaiming_uniform_": (2.0, "fan_in", "uniform"),
    "kaiming_normal_": (2.0, "fan_in", "truncated_normal"),
}
# std of a standard normal truncated to [-2, 2]: flax divides by it
TRUNCATED_STD = 0.87962566103423978


def variance_scaling_(w: torch.Tensor, scale: float, mode: str, distribution: str,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
    """``flax.linen.initializers.variance_scaling`` in place: variance
    scale/fan, the fans of a torch weight (out, in, *kernel) being flax's
    (*kernel, in, out) ones; "uniform" on ±√(3·variance),
    "truncated_normal" a normal truncated to ±2σ rescaled to the variance."""
    fan_in, fan_out = nn.init._calculate_fan_in_and_fan_out(w)
    variance = scale / (fan_in if mode == "fan_in" else (fan_in + fan_out) / 2.0)
    if distribution == "uniform":
        limit = math.sqrt(3.0 * variance)
        return nn.init.uniform_(w, -limit, limit, generator=generator)
    std = math.sqrt(variance) / TRUNCATED_STD
    return nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


class _RowProduct(torch.autograd.Function):
    """``x @ w.T`` for 2-D ``x``: each row its own one-row product, summed in
    float64 and rounded once to ``x``'s dtype.

    A batched product over the rows gives every row the same kernel, so a
    row's value does not depend on how many rows share the call; the
    float64 sum of the (exact) float32 products makes it the same whatever
    kernel or order the BLAS picks, on any host. The weight's gradient is a
    sum over the rows and stays one GEMM; the input's gradient is a row
    product again, so double backward (HATRPO's Fisher-vector products)
    stays row by row too.
    """

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        rows = torch.bmm(x.double().unsqueeze(1), w.double().t().expand(x.shape[0], -1, -1))
        return rows.squeeze(1).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()      # a broadcast gradient (of a sum) has stride 0
        return _RowProduct.apply(g, w.t()), g.t() @ x


class RowLinear(nn.Linear):
    """``nn.Linear`` whose rows on the CPU do not depend on the batch's width.

    MKL picks its GEMM kernel by the number of rows, so a row's sums
    round apart between widths (a lone row against the same row among
    many, and at many widths for a one-column head). A data-parallel rank
    holding one env would then compute its rows apart from the one-rank
    run holding two. On the CPU every row goes through ``_RowProduct``
    instead; on the card the layer is cuBLAS's ``F.linear``, as before.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda:
            return F.linear(x, self.weight, self.bias)
        rows = x.reshape(-1, self.in_features)
        out = _RowProduct.apply(rows, self.weight) + self.bias
        return out.reshape(*x.shape[:-1], self.out_features)


def make_linear(in_dim: int, out_dim: int, init, device, generator) -> nn.Linear:
    """Linear layer with ``init`` on the weight and a zero bias."""
    layer = RowLinear(in_dim, out_dim, device=device)
    with torch.no_grad():
        init(layer.weight, generator)
        layer.bias.zero_()
    return layer


def lecun_normal_(w: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's default Dense kernel init: variance_scaling(1, fan_in,
    truncated_normal), a normal truncated to ±2σ rescaled to variance 1/fan_in."""
    return variance_scaling_(w, 1.0, "fan_in", "truncated_normal", generator)


class PlainMLP(nn.Module):
    """Reference PlainMLP (plain_mlp.py): ``sizes`` includes the output width;
    the last layer uses ``final_activation_func``."""

    def __init__(self, in_dim: int, sizes: Sequence[int], activation_func: str = "relu",
                 final_activation_func: str = "identity",
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [in_dim, *sizes]
        self.fc = nn.ModuleList(
            make_linear(a, b, lecun_normal_, device, generator)
            for a, b in zip(dims[:-1], dims[1:]))
        self.acts = [ACTIVATIONS[activation_func]] * (len(sizes) - 1) + [
            ACTIVATIONS[final_activation_func]]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for fc, act in zip(self.fc, self.acts):
            x = act(fc(x))
        return x


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
