"""JAX-package parameters → the port's ``state_dict``s.

Takes the flax parameter trees as nested dicts of numpy arrays (convert with
``jax.tree.map(np.asarray, params)`` on the JAX side), so this module never
imports JAX. A flax ``Dense.kernel`` is (in, out) and a torch
``Linear.weight`` (out, in), so kernels are transposed; LayerNorm
``scale``/``bias`` map to ``weight``/``bias``. Covers ``StochasticPolicy``
(MLP, Box head) and ``VNet`` (MLP).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _dense(prefix: str, p: Mapping) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(np.asarray(p["kernel"]).T), f"{prefix}.bias": _t(p["bias"])}


def _layer_norm(prefix: str, p: Mapping) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(p["scale"]), f"{prefix}.bias": _t(p["bias"])}


def _mlp_base(p: Mapping) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    if "feature_norm" in p:
        out.update(_layer_norm("base.feature_norm", p["feature_norm"]))
    i = 0
    while f"fc{i}" in p:
        out.update(_dense(f"base.fc.{i}", p[f"fc{i}"]))
        out.update(_layer_norm(f"base.ln.{i}", p[f"ln{i}"]))
        i += 1
    return out


def _params(tree: Mapping) -> Mapping:
    return tree["params"] if "params" in tree else tree


def policy_state_dict(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """``StochasticPolicy`` (MLP path, Box head) parameters."""
    p = _params(flax_params)
    out = _mlp_base(p["base"])
    out.update(_dense("act.head", p["act"]["head"]))
    out["act.log_std"] = _t(p["act"]["log_std"])
    return out


def vnet_state_dict(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """``VNet`` (MLP path) parameters."""
    p = _params(flax_params)
    out = _mlp_base(p["base"])
    out.update(_dense("v_out", p["v_out"]))
    return out
