"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller names another device. A host
without CUDA raises instead of dropping silently to the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means CUDA; a CUDA device on a host without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "harl_tpu_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU explicitly"
            )
        # Full-precision float32 matmuls and convolutions, as the JAX
        # reference computes them: TF32 would keep ~3 decimal digits and
        # break parity with the reference. Set explicitly, not left to the
        # library defaults.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
