"""Framework-free action/observation space descriptions.

The port's own copy of the Box / Discrete helpers and ``space_kind`` of
``harl_tpu/utils/spaces.py``: small frozen dataclasses that describe a
space without holding tensors.
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
class Discrete:
    """Single categorical action (reference: gym.spaces.Discrete)."""

    n: int

    @property
    def shape(self) -> Tuple[int, ...]:
        return (1,)

    @property
    def dim(self) -> int:
        return 1


def space_kind(space) -> str:
    """The reference's class-name dispatch (act.py:24, envs_tools.py:15-46)."""
    if isinstance(space, Box):
        return "Box"
    if isinstance(space, Discrete):
        return "Discrete"
    name = type(space).__name__
    if name in ("Box", "Discrete", "MultiDiscrete"):
        return name
    raise TypeError(f"Unsupported space: {space!r}")
