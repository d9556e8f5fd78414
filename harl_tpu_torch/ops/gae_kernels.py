"""GAE and discounted-return kernels: wrappers, launch counts, plain versions.

Replaces ``harl_tpu/ops/pallas_gae.py`` (``gae_pallas`` → ``_gae_kernel`` and
``discounted_returns_pallas`` → ``_returns_kernel``). The CUDA kernels are in
``csrc/gae.cu``: one thread per column walks t = T−1 … 0 with the carry in a
register, reading the time-major (T, b) and (T+1, b) tensors in place, with
coalesced loads along b. They are bound by bytes: ~(4T+3)·b floats move for
GAE with bad masks, ~2.7 MB at the main-path shape (T=32, b=4096), ~0.8 µs at
an H100 SXM's 3.35 TB/s; at that size the kernel fills 32 blocks and is
latency-bound instead (see PERF.md).

Dispatch is by the tensors' device: a CUDA tensor launches the kernel, and a
launch that is refused raises; a CPU tensor takes the plain version. There is
no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from harl_tpu_torch.ops import _build

@functools.cache
def _lib() -> ctypes.CDLL:
    """``csrc/gae.cu``, built at first use, with its entry points typed."""
    lib = _build.load("gae")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.harl_gae.argtypes = [p, p, p, p, p, i, i, f, f, p]
    lib.harl_gae.restype = ctypes.c_int
    lib.harl_discounted_returns.argtypes = [p, p, p, p, p, p, i, i, f, p]
    lib.harl_discounted_returns.restype = ctypes.c_int
    return lib


def _check(rewards, values, masks, bad_masks, next_value=None) -> None:
    """Same device, float32, contiguous, and the (T, …)/(T+1, …) shapes."""
    T, trailing = rewards.shape[0], tuple(rewards.shape[1:])
    named = [("rewards", rewards, (T,) + trailing),
             ("values", values, (T + 1,) + trailing),
             ("masks", masks, (T + 1,) + trailing)]
    if bad_masks is not None:
        named.append(("bad_masks", bad_masks, (T + 1,) + trailing))
    if next_value is not None:
        named.append(("next_value", next_value, trailing))
    for name, x, shape in named:
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != rewards.device:
            raise ValueError(f"{name} is on {x.device}, rewards on {rewards.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    return None if x is None else x.data_ptr()


def _raise_if_failed(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


# ------------------------------------------------------------------ GAE
def gae_reference(rewards, values, masks, bad_masks, gamma: float, lam: float):
    """Plain version of the GAE recursion (a Python loop over T)."""
    T = rewards.shape[0]
    out = torch.empty_like(rewards)
    g = torch.zeros_like(rewards[0])
    for t in range(T - 1, -1, -1):
        m = masks[t + 1]
        delta = rewards[t] + gamma * values[t + 1] * m - values[t]
        g = delta + (gamma * lam) * m * g
        if bad_masks is not None:
            g = g * bad_masks[t + 1]
        out[t] = g + values[t]
    return out


def gae(rewards: torch.Tensor, values: torch.Tensor, masks: torch.Tensor,
        bad_masks: Optional[torch.Tensor], gamma: float, lam: float) -> torch.Tensor:
    """GAE returns (gae + V): rewards (T, …); values, masks, bad_masks
    (T+1, …), ``bad_masks=None`` meaning no truncations. Output (T, …)."""
    _check(rewards, values, masks, bad_masks)
    if rewards.device.type == "cpu":
        return gae_reference(rewards, values, masks, bad_masks, gamma, lam)
    if rewards.device.type != "cuda":
        raise ValueError(f"gae runs on cuda or cpu tensors, not {rewards.device}")
    T, b = rewards.shape[0], math.prod(rewards.shape[1:])
    out = torch.empty_like(rewards)
    with torch.cuda.device(rewards.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().harl_gae(
            rewards.data_ptr(), values.data_ptr(), masks.data_ptr(), _ptr(bad_masks),
            out.data_ptr(), T, b, gamma, gamma * lam, stream)
    _raise_if_failed(err, "gae")
    gae.launches += 1
    return out


gae.launches = 0


# ------------------------------------------------------ discounted returns
def discounted_returns_reference(rewards, values, masks, bad_masks, next_value,
                                 gamma: float):
    """Plain version of the discounted-return recursion (a loop over T)."""
    T = rewards.shape[0]
    out = torch.empty_like(rewards)
    ret = next_value
    for t in range(T - 1, -1, -1):
        bm = torch.ones_like(ret) if bad_masks is None else bad_masks[t + 1]
        ret = (ret * gamma * masks[t + 1] + rewards[t]) * bm + (1.0 - bm) * values[t]
        out[t] = ret
    return out


def discounted_returns(rewards: torch.Tensor, values: torch.Tensor, masks: torch.Tensor,
                       bad_masks: Optional[torch.Tensor], next_value: torch.Tensor,
                       gamma: float) -> torch.Tensor:
    """Discounted returns seeded with ``next_value`` (…); shapes as ``gae``."""
    _check(rewards, values, masks, bad_masks, next_value)
    if rewards.device.type == "cpu":
        return discounted_returns_reference(rewards, values, masks, bad_masks,
                                            next_value, gamma)
    if rewards.device.type != "cuda":
        raise ValueError(
            f"discounted_returns runs on cuda or cpu tensors, not {rewards.device}")
    T, b = rewards.shape[0], math.prod(rewards.shape[1:])
    out = torch.empty_like(rewards)
    with torch.cuda.device(rewards.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().harl_discounted_returns(
            rewards.data_ptr(), values.data_ptr(), masks.data_ptr(), _ptr(bad_masks),
            next_value.data_ptr(), out.data_ptr(), T, b, gamma, stream)
    _raise_if_failed(err, "discounted_returns")
    discounted_returns.launches += 1
    return out


discounted_returns.launches = 0
