"""Where the port's random numbers come from.

The JAX package derives every draw from explicit PRNG keys. The port draws
from one ``torch.Generator`` per runner through a noise source, an object
with seven methods that the runners and the vectorised env call in a fixed
order (each runner's docstring gives its order):

    action_noise(shape)                standard normal: a Box agent's action noise, and
                                       the off-policy target and update normals
    gumbel_noise(shape)                standard Gumbel: a Discrete agent's sample (on-policy
                                       Gumbel-max, HASAC's straight-through Gumbel-softmax)
    reset_noise(n_envs, spec)          one (n_envs, width) tensor per entry of the env's
                                       ``reset_noise_spec``, in its order: ("uniform", w)
                                       on [0, 1), ("normal", w) standard normal,
                                       ("randint", w, high) integers in [0, high)
    permutation(n)                     a random permutation of range(n); the host reads it
    uniform(shape)                     uniform on [0, 1): the off-policy Box warmup actions,
                                       HAD3QN's exploration coin
    indices(n, high)                   n integers in [0, high), drawn with replacement:
                                       the replay buffer's sample starts
    randint(shape, high)               integers in [0, high): discrete warmup actions and
                                       HAD3QN's random exploration actions

``GeneratorNoise`` is the production source. A test can pass any object with
the same methods, e.g. one that replays the JAX package's draws.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


class GeneratorNoise:
    """Draws from ``generator`` and hands the result out on ``device``. With
    a ``host_generator`` (a CPU one), permutations are drawn from it and stay
    on the host, so reading an agent order does not wait on the device."""

    def __init__(self, generator: torch.Generator, device: torch.device,
                 host_generator: Optional[torch.Generator] = None):
        self.generator = generator
        self.device = torch.device(device)
        self.host_generator = host_generator

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

    def reset_noise(self, n_envs: int, spec: Sequence[tuple]) -> Tuple[torch.Tensor, ...]:
        draw = {"uniform": self.uniform, "normal": self.action_noise, "randint": self.randint}
        return tuple(draw[kind]((n_envs, width), *high) for kind, width, *high in spec)

    def permutation(self, n: int) -> torch.Tensor:
        if self.host_generator is not None:
            return torch.randperm(n, generator=self.host_generator)
        return self._out(torch.randperm(n, generator=self.generator,
                                        device=self.generator.device))

    def uniform(self, shape: Sequence[int]) -> torch.Tensor:
        return self._out(torch.rand(tuple(shape), generator=self.generator,
                                    device=self.generator.device))

    def indices(self, n: int, high: int) -> torch.Tensor:
        return self._out(torch.randint(0, high, (n,), generator=self.generator,
                                       device=self.generator.device))

    def randint(self, shape: Sequence[int], high: int) -> torch.Tensor:
        return self._out(torch.randint(0, high, tuple(shape), generator=self.generator,
                                       device=self.generator.device))
