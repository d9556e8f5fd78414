"""JAX-package parameters → the port's ``state_dict``s.

Takes the flax parameter trees as nested dicts of numpy arrays (convert with
``jax.tree.map(np.asarray, params)`` on the JAX side), so this module never
imports JAX. A flax ``Dense.kernel`` is (in, out) and a torch
``Linear.weight`` (out, in), so kernels are transposed; LayerNorm
``scale``/``bias`` map to ``weight``/``bias``. The GRU's fused weights
(``rnn/wi{i}``, ``wh{i}``, ``bi{i}``, ``bh{i}``) keep the flax layout and copy
as they are, its output LayerNorm is ``rnn/norm``. A ``CNNBase`` torso's
``conv`` kernel is HWIO in flax and OIHW in torch; its Dense rows follow
the (H, W, C) flatten order in both. Covers ``StochasticPolicy`` (MLP or
CNN, optional GRU, Box, Discrete or MultiDiscrete ``head{i}`` heads) and
``VNet`` (MLP or CNN, optional GRU),
the off-policy networks on ``PlainMLP`` (``fc{i}`` → ``fc.{i}``):
``SquashedGaussianPolicy``, ``DeterministicPolicy`` and ``ContinuousQNet``,
the last also as a tuple of twin nets, and HAD3QN's ``DuelingQNet`` (alone,
or as the critic's tuple of one). Discrete HASAC's ``StochasticMlpPolicy``
has ``StochasticPolicy``'s names (``base``, ``act/head``), so
``policy_state_dict`` converts it. ``plain_cnn_state_dict`` converts a
``PlainCNN`` (``conv``, ``fc``).
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _dense(prefix: str, p: Mapping) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(np.asarray(p["kernel"]).T), f"{prefix}.bias": _t(p["bias"])}


def _layer_norm(prefix: str, p: Mapping) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(p["scale"]), f"{prefix}.bias": _t(p["bias"])}


def _mlp_base(p: Mapping) -> Dict[str, torch.Tensor]:
    """``MLPBase`` or, with a ``conv``, ``CNNBase``."""
    out: Dict[str, torch.Tensor] = {}
    if "conv" in p:
        out.update(_conv("base.conv", p["conv"]))
    if "feature_norm" in p:
        out.update(_layer_norm("base.feature_norm", p["feature_norm"]))
    i = 0
    while f"fc{i}" in p:
        out.update(_dense(f"base.fc.{i}", p[f"fc{i}"]))
        out.update(_layer_norm(f"base.ln.{i}", p[f"ln{i}"]))
        i += 1
    return out


def _conv(prefix: str, p: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``Conv`` (HWIO kernel) → a torch ``Conv2d`` (OIHW weight)."""
    return {f"{prefix}.weight": _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))),
            f"{prefix}.bias": _t(p["bias"])}


def _gru(p: Mapping) -> Dict[str, torch.Tensor]:
    out = {f"rnn.{k}": _t(v) for k, v in p.items() if k != "norm"}
    out.update(_layer_norm("rnn.norm", p["norm"]))
    return out


def _params(tree: Mapping) -> Mapping:
    return tree["params"] if "params" in tree else tree


def policy_state_dict(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """``StochasticPolicy`` parameters: MLP or CNN, optional GRU, Box,
    Discrete or MultiDiscrete heads; also ``StochasticMlpPolicy``'s (MLP,
    Discrete or MultiDiscrete heads)."""
    p = _params(flax_params)
    out = _mlp_base(p["base"])
    if "rnn" in p:
        out.update(_gru(p["rnn"]))
    for name in p["act"]:
        if name.startswith("head"):
            out.update(_dense(f"act.{name}", p["act"][name]))
    if "log_std" in p["act"]:
        out["act.log_std"] = _t(p["act"]["log_std"])
    return out


def vnet_state_dict(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """``VNet`` parameters: MLP, optional GRU."""
    p = _params(flax_params)
    out = _mlp_base(p["base"])
    if "rnn" in p:
        out.update(_gru(p["rnn"]))
    out.update(_dense("v_out", p["v_out"]))
    return out


def plain_mlp_state_dict(flax_params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``PlainMLP``: {fc0, fc1, …} → ``{prefix}fc.{i}``."""
    p = _params(flax_params)
    out: Dict[str, torch.Tensor] = {}
    for i in range(len(p)):
        out.update(_dense(f"{prefix}fc.{i}", p[f"fc{i}"]))
    return out


def squashed_policy_state_dict(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """``SquashedGaussianPolicy``: {"net": {fc0, fc1}, "mu", "log_std"}."""
    p = _params(flax_params)
    out = plain_mlp_state_dict(p["net"], "net.")
    out.update(_dense("mu", p["mu"]))
    out.update(_dense("log_std", p["log_std"]))
    return out


def deterministic_policy_state_dict(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """``DeterministicPolicy``: {"pi": {fc0, fc1, fc2}}."""
    return plain_mlp_state_dict(_params(flax_params)["pi"], "pi.")


def q_net_state_dict(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """``ContinuousQNet``: {"mlp": {fc0, fc1, fc2}}."""
    return plain_mlp_state_dict(_params(flax_params)["mlp"], "mlp.")


def dueling_q_state_dict(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """``DuelingQNet``: {"base", "dueling_v", "dueling_a"}, each a PlainMLP."""
    p = _params(flax_params)
    out: Dict[str, torch.Tensor] = {}
    for name in ("base", "dueling_v", "dueling_a"):
        out.update(plain_mlp_state_dict(p[name], f"{name}."))
    return out


def q_nets_state_dict(flax_params: Sequence[Mapping],
                      net=q_net_state_dict) -> Dict[str, torch.Tensor]:
    """A tuple of Q-net parameters (one, or twins) → the ``state_dict`` of an
    ``nn.ModuleList`` of them; ``net`` converts one (``ContinuousQNet``
    unless given, e.g. ``dueling_q_state_dict``)."""
    return {f"{i}.{k}": v for i, p in enumerate(flax_params) for k, v in net(p).items()}


def plain_cnn_state_dict(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """``PlainCNN`` parameters: ``conv`` and ``fc``."""
    p = _params(flax_params)
    return {**_conv("conv", p["conv"]), **_dense("fc", p["fc"])}
