"""Recurrent (GRU) layer with mask-based hidden resets (counterpart of
``harl_tpu/models/rnn.py``).

A ``recurrent_n``-layer GRU in the torch ``nn.GRU`` convention

    r = σ(x Wir + bir + h Whr + bhr)
    z = σ(x Wiz + biz + h Whz + bhz)
    n = tanh(x Win + bin + r ⊙ (h Whn + bhn))
    h' = (1 − z) ⊙ n + z ⊙ h

with the weights fused as in the JAX module: ``wi{i}`` (in, 3H), ``wh{i}``
(H, 3H), biases (3H,), gates ordered r, z, n, so flax parameters load without
a transpose. Before each step the hidden state is multiplied by the step's
mask, so an episode boundary inside a sequence resets it (rnn.py:27); that is
why the cell is written out rather than taken from ``nn.GRU``. Step mode
takes one (N, d) input, sequence mode a time-major (T, N, d) one and loops
over T. The output goes through a LayerNorm with flax's eps of 1e-6.
Hidden states are (N, recurrent_n, H), the reference buffers' layout.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from harl_tpu_torch.models.mlp import LAYER_NORM_EPS


class GRUStack(nn.Module):
    def __init__(self, in_dim: int, hidden_size: int, recurrent_n: int = 1,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.recurrent_n = recurrent_n
        H = hidden_size
        for i in range(recurrent_n):
            d = in_dim if i == 0 else H
            for name, shape in ((f"wi{i}", (d, 3 * H)), (f"wh{i}", (H, 3 * H))):
                w = torch.empty(shape, device=device)
                nn.init.orthogonal_(w, generator=generator)
                self.register_parameter(name, nn.Parameter(w))
            for name in (f"bi{i}", f"bh{i}"):
                self.register_parameter(name, nn.Parameter(torch.zeros(3 * H, device=device)))
        self.norm = nn.LayerNorm(H, eps=LAYER_NORM_EPS, device=device)

    def _layer(self, i: int):
        return (getattr(self, f"wi{i}"), getattr(self, f"wh{i}"), getattr(self, f"bi{i}"),
                getattr(self, f"bh{i}"))

    @staticmethod
    def _cell(x, h, wi, wh, bi, bh):
        i_r, i_z, i_n = torch.addmm(bi, x, wi).chunk(3, dim=-1)
        h_r, h_z, h_n = torch.addmm(bh, h, wh).chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h

    def _step(self, x: torch.Tensor, h: torch.Tensor, m: torch.Tensor):
        h = h * m[..., None]          # reset the hidden state where mask == 0
        layers = []
        for i in range(self.recurrent_n):
            x = self._cell(x, h[:, i], *self._layer(i))
            layers.append(x)
        return x, torch.stack(layers, dim=1)

    def forward(self, x: torch.Tensor, h: torch.Tensor, masks: torch.Tensor,
                seq: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """seq=False: x (N, d), masks (N, 1) → (out (N, H), h (N, L, H)).
        seq=True:  x (T, N, d), masks (T, N, 1) → (out (T, N, H), h (N, L, H))."""
        if not seq:
            out, h = self._step(x, h, masks)
        else:
            outs = []
            for t in range(x.shape[0]):
                o, h = self._step(x[t], h, masks[t])
                outs.append(o)
            out = torch.stack(outs)
        return self.norm(out), h
