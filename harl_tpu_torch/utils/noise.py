"""Where the port's random numbers come from.

The JAX package derives every draw from explicit PRNG keys. The port draws
from one ``torch.Generator`` per runner through a noise source, an object
with four methods that the runner and the vectorised env call in a fixed
order each training iteration:

    action_noise(shape)                standard normal, one call per Box agent per step
    gumbel_noise(shape)                standard Gumbel, one call per Discrete agent per step
    reset_noise(n_envs, dof)           (uniform [0, 1), standard normal), (n_envs, dof) each
    permutation(n)                     a random permutation of range(n)

``GeneratorNoise`` is the production source. A test can pass any object with
the same methods, e.g. one that replays the JAX package's draws.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


class GeneratorNoise:
    """Draws from ``generator`` and hands the result out on ``device``."""

    def __init__(self, generator: torch.Generator, device: torch.device):
        self.generator = generator
        self.device = torch.device(device)

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device)

    def action_noise(self, shape: Sequence[int]) -> torch.Tensor:
        return self._out(torch.randn(tuple(shape), generator=self.generator,
                                     device=self.generator.device))

    def gumbel_noise(self, shape: Sequence[int]) -> torch.Tensor:
        """−log(−log u), u uniform on [tiny, 1), as ``jax.random.gumbel``."""
        g = self.generator
        u = torch.rand(tuple(shape), generator=g, device=g.device)
        u = torch.clamp(u, min=torch.finfo(u.dtype).tiny)
        return self._out(-torch.log(-torch.log(u)))

    def reset_noise(self, n_envs: int, dof: int) -> Tuple[torch.Tensor, torch.Tensor]:
        g = self.generator
        u = torch.rand((n_envs, dof), generator=g, device=g.device)
        n = torch.randn((n_envs, dof), generator=g, device=g.device)
        return self._out(u), self._out(n)

    def permutation(self, n: int) -> torch.Tensor:
        return self._out(torch.randperm(n, generator=self.generator,
                                        device=self.generator.device))
