"""CNN torso for pixel observations (counterpart of ``harl_tpu/models/cnn.py``).

``CNNBase`` (reference: harl/models/base/cnn.py, CNNBase/CNNLayer): inputs
/255, one k×k stride-s convolution to ``hidden_sizes[0] // 2`` channels
with SAME padding (flax ``nn.Conv``'s default), the activation, a flatten,
then [Linear → activation → LayerNorm] per hidden size, orthogonal init
with the activation's gain. Inputs are channel-last (…, H, W, C), as in the
JAX package; the convolution runs channel-first and its output is flattened
back in (H, W, C) order, so the first Linear's rows are flax's.

``PlainCNN`` (reference: harl/models/base/plain_cnn.py): inputs /255, one
k×k stride-1 convolution to 32 channels with SAME padding, the activation,
a flatten and one Linear to ``out_dim`` with the activation, no LayerNorm;
flax's default inits (LeCun normal, zero bias). The JAX package builds it
for no runner; it is ported with its forward held against flax's.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from harl_tpu_torch.models.mlp import (ACTIVATION_GAIN, ACTIVATIONS, LAYER_NORM_EPS, get_init,
                                       lecun_normal_, make_linear)


class CNNBase(nn.Module):
    """conv(k, s) → flatten → [Linear + act + LayerNorm]* (cnn.py:20-87);
    ``obs_shape`` is (H, W, C)."""

    def __init__(self, obs_shape: Tuple[int, int, int], hidden_sizes: Sequence[int],
                 activation_func: str = "relu", initialization_method: str = "orthogonal_",
                 kernel_size: int = 3, stride: int = 1,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        H, W, C = obs_shape
        if stride != 1:
            # SAME padding with a stride is asymmetric in flax; the JAX
            # package only builds stride 1
            raise ValueError("CNNBase is ported for stride 1")
        self.act = ACTIVATIONS[activation_func]
        init = get_init(initialization_method, ACTIVATION_GAIN.get(activation_func, 1.0))
        features = hidden_sizes[0] // 2
        self.conv = nn.Conv2d(C, features, kernel_size, stride, padding="same", device=device)
        with torch.no_grad():
            init(self.conv.weight, generator)
            self.conv.bias.zero_()
        dims = [H * W * features, *hidden_sizes]
        self.fc = nn.ModuleList(
            make_linear(a, b, init, device, generator) for a, b in zip(dims[:-1], dims[1:]))
        self.ln = nn.ModuleList(
            nn.LayerNorm(h, eps=LAYER_NORM_EPS, device=device) for h in hidden_sizes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-3]
        x = (x.reshape((-1,) + tuple(x.shape[-3:])) / 255.0).permute(0, 3, 1, 2)
        x = self.act(self.conv(x)).permute(0, 2, 3, 1)          # back to (N, H, W, F)
        x = x.reshape(lead + (-1,))
        for fc, ln in zip(self.fc, self.ln):
            x = ln(self.act(fc(x)))
        return x


class PlainCNN(nn.Module):
    """conv(k, 32 channels) → act → flatten → Linear(out_dim) → act
    (plain_cnn.py); ``obs_shape`` is (H, W, C)."""

    def __init__(self, obs_shape: Tuple[int, int, int], out_dim: int,
                 activation_func: str = "relu", kernel_size: int = 3, stride: int = 1,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        H, W, C = obs_shape
        if stride != 1:
            raise ValueError("PlainCNN is ported for stride 1")
        self.act = ACTIVATIONS[activation_func]
        self.conv = nn.Conv2d(C, 32, kernel_size, stride, padding="same", device=device)
        with torch.no_grad():
            lecun_normal_(self.conv.weight, generator)
            self.conv.bias.zero_()
        self.fc = make_linear(H * W * 32, out_dim, lecun_normal_, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-3]
        x = (x.reshape((-1,) + tuple(x.shape[-3:])) / 255.0).permute(0, 3, 1, 2)
        x = self.act(self.conv(x)).permute(0, 2, 3, 1)
        return self.act(self.fc(x.reshape(lead + (-1,))))
