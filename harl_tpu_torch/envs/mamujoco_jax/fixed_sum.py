"""Sums whose order depends on the summed axis alone, for the env physics.

On CUDA a contraction through cuBLAS (``matmul``, ``bmm``, ``einsum``) picks
its kernel, and with it the order in which each output's terms are added,
from the whole problem's shape, the batch count among it. So an env's next
state would round differently in a batch of 20 envs than in one of 4,096,
and a seed's trajectory would depend on how many envs share its batch
(``scripts/torch_planar_width.py`` names each such op). ``fixed_sum`` adds
with elementwise ops only, in a pairwise tree fixed by the length of the
summed axis: every row of the result is the same bits at every batch
width, on the card as on the CPU.
"""
from __future__ import annotations

import torch


def fixed_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Σ of ``x`` over ``dim`` (dropped), as a fixed pairwise tree of
    elementwise adds: the first half plus the second half, again and again;
    an odd length's middle term is set aside and added after the tree, the
    earliest set aside last (24 terms: 12 + 12, 6 + 6, 3 + 3, then two adds)."""
    dim = dim % x.dim()
    n = x.shape[dim]
    if n == 0:
        return x.new_zeros(x.shape[:dim] + x.shape[dim + 1:])
    rest = []
    while n > 1:
        h = n // 2
        if n % 2:
            rest.append(x.narrow(dim, h, 1))
        x = x.narrow(dim, 0, h) + x.narrow(dim, n - h, h)
        n = h
    for r in reversed(rest):
        x = x + r
    return x.squeeze(dim)
