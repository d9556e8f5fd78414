"""GAE and discounted-return kernels: wrappers, launch counts, plain versions.

Replaces ``harl_tpu/ops/pallas_gae.py`` (``gae_pallas`` → ``_gae_kernel`` and
``discounted_returns_pallas`` → ``_returns_kernel``). The CUDA kernels are in
``csrc/gae.cu``: a block owns W neighbouring columns, copies chunks of Tc rows
of its inputs into a ring of shared-memory stages with ``cp.async`` (all of
them at once at the main path's shape), and one thread per column walks
t = T−1 … 0 through the stages with the carry in a register. They are bound
by bytes: (5T+1)·b floats move for GAE with bad masks, 2.64 MB at the main
path's shape (T=32, b=4096), 0.787 µs at an H100 SXM's 3.35 TB/s (PERF.md).
``_launch_geometry`` chooses W, Tc and the grid; the C entry checks them.

Dispatch is by the tensors' device: a CUDA tensor launches the kernel, and a
launch that is refused raises; a CPU tensor takes the plain version. There is
no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from harl_tpu_torch.ops import _build

# The ring's depth; csrc/gae.cu's kStages, which the C entry checks.
STAGES = 4
# Arrays staged per row segment: rewards, values, masks, bad masks.
_ARRAYS = 4
# Blocks wanted at least: about one for each of an H100's 132 SMs.
_MIN_BLOCKS = 128
# Tc·W at most: 16 KB a stage, 64 KB for the ring.
_STAGE_FLOATS = 1024
# Shared memory a block may use on sm_90 (227 KB); above 48 KB only after
# the opt-in that csrc/gae.cu makes once per kernel.
MAX_SMEM = 232448
DEFAULT_SMEM = 48 * 1024


@functools.lru_cache(maxsize=256)
def _launch_geometry(T: int, b: int) -> Tuple[int, int, int, int, int]:
    """(W, Tc, stages, shared bytes, grid) of the kernels at (T, b).

    W, the columns of a block, is the widest of 32, 16 and 8 that still gives
    ``_MIN_BLOCKS`` blocks (8 floats are one 32-byte sector of a row). Tc, the
    rows of a chunk, is all of T up to ``_STAGE_FLOATS // W`` rows: one chunk,
    one wait and one barrier where T fits (the main path: T=32 at W=32), a
    ring of STAGES chunks in flight where it does not. Shared memory holds
    the stages in use, min(STAGES, chunks).
    """
    W = next((w for w in (32, 16) if -(-b // w) >= _MIN_BLOCKS), 8)
    Tc = max(1, min(T, _STAGE_FLOATS // W))
    smem = min(STAGES, -(-T // Tc)) * _ARRAYS * Tc * W * 4
    return W, Tc, STAGES, smem, -(-b // W)


@functools.cache
def _lib() -> ctypes.CDLL:
    """``csrc/gae.cu``, built at first use, with its entry points typed."""
    lib = _build.load("gae")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.harl_gae.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, f, f, p]
    lib.harl_gae.restype = ctypes.c_int
    lib.harl_discounted_returns.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, f, p]
    lib.harl_discounted_returns.restype = ctypes.c_int
    return lib


def _check(rewards, values, masks, bad_masks, next_value=None) -> None:
    """Same device, float32, contiguous, and the (T, …)/(T+1, …) shapes.

    Each tensor's shape is compared whole with one tuple built per call:
    slicing a ``torch.Size`` per tensor cost more than the launch itself.
    """
    shape, dev = rewards.shape, rewards.device
    longer = (shape[0] + 1,) + shape[1:]
    for name, x, want in (("rewards", rewards, shape), ("values", values, longer),
                          ("masks", masks, longer), ("bad_masks", bad_masks, longer),
                          ("next_value", next_value, shape[1:])):
        if x is None:
            continue
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, rewards on {dev}")
        if x.shape != want:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(want)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(entry, dev: torch.device, *args) -> int:
    """Call a C entry with the stream of ``dev`` appended; the device is
    switched only when it is not the current one."""
    if dev.index == torch.cuda.current_device():
        return entry(*args, torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        return entry(*args, torch.cuda.current_stream(dev).cuda_stream)


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
    dev = rewards.device
    if dev.type == "cpu":
        return gae_reference(rewards, values, masks, bad_masks, gamma, lam)
    if dev.type != "cuda":
        raise ValueError(f"gae runs on cuda or cpu tensors, not {dev}")
    out = torch.empty_like(rewards)
    if out.numel() == 0:
        return out
    T = rewards.shape[0]
    b = out.numel() // T
    err = _launch(_lib().harl_gae, dev,
                  rewards.data_ptr(), values.data_ptr(), masks.data_ptr(), _ptr(bad_masks),
                  out.data_ptr(), T, b, *_launch_geometry(T, b), gamma, gamma * lam)
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
    dev = rewards.device
    if dev.type == "cpu":
        return discounted_returns_reference(rewards, values, masks, bad_masks,
                                            next_value, gamma)
    if dev.type != "cuda":
        raise ValueError(f"discounted_returns runs on cuda or cpu tensors, not {dev}")
    out = torch.empty_like(rewards)
    if out.numel() == 0:
        return out
    T = rewards.shape[0]
    b = out.numel() // T
    err = _launch(_lib().harl_discounted_returns, dev,
                  rewards.data_ptr(), values.data_ptr(), masks.data_ptr(), _ptr(bad_masks),
                  next_value.data_ptr(), out.data_ptr(), T, b, *_launch_geometry(T, b),
                  gamma)
    _raise_if_failed(err, "discounted_returns")
    discounted_returns.launches += 1
    return out


discounted_returns.launches = 0
