"""Framework-free action/observation space descriptions.

The port's own copy of the Box / ImageBox / Discrete / MultiDiscrete
helpers and ``space_kind`` of ``harl_tpu/utils/spaces.py``: small frozen
dataclasses that describe a space without holding tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Box:
    """Continuous space with per-dim bounds (reference: gym.spaces.Box)."""

    low: Tuple[float, ...]
    high: Tuple[float, ...]

    @property
    def shape(self) -> Tuple[int, ...]:
        return (len(self.low),)

    @property
    def dim(self) -> int:
        return len(self.low)

    @staticmethod
    def create(low, high, dim=None):
        if np.isscalar(low):
            if dim is None:
                raise ValueError("a scalar bound needs dim")
            low = [float(low)] * dim
            high = [float(high)] * dim
        return Box(tuple(float(x) for x in low), tuple(float(x) for x in high))


@dataclasses.dataclass(frozen=True)
class ImageBox:
    """Pixel observation space (H, W, C), channel-last (reference: a 3-dim
    gym Box routed to CNNBase, stochastic_policy.py:34-36)."""

    height: int
    width: int
    channels: int
    low: float = 0.0
    high: float = 255.0

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.height, self.width, self.channels)

    @property
    def dim(self) -> int:
        return self.height * self.width * self.channels


@dataclasses.dataclass(frozen=True)
class Discrete:
    """Single categorical action (reference: gym.spaces.Discrete)."""

    n: int

    @property
    def shape(self) -> Tuple[int, ...]:
        return (1,)

    @property
    def dim(self) -> int:
        return 1


@dataclasses.dataclass(frozen=True)
class MultiDiscrete:
    """Vector of categorical actions (reference: gym.spaces.MultiDiscrete).
    An action is ``len(nvec)`` indices; its logits and availability rows
    are ``sum(nvec)`` wide."""

    nvec: Tuple[int, ...]

    @property
    def shape(self) -> Tuple[int, ...]:
        return (len(self.nvec),)

    @property
    def dim(self) -> int:
        return len(self.nvec)


def space_kind(space) -> str:
    """The reference's class-name dispatch (act.py:24, envs_tools.py:15-46)."""
    for cls in (Box, ImageBox, Discrete, MultiDiscrete):
        if isinstance(space, cls):
            return cls.__name__
    name = type(space).__name__
    if name in ("Box", "Discrete", "MultiDiscrete"):
        return name
    raise TypeError(f"Unsupported space: {space!r}")
