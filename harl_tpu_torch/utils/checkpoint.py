"""Checkpoint and restore of the full train state (counterpart of
``harl_tpu/utils/checkpoint.py``), with ``torch.save``/``torch.load``.

A runner's state (dataclasses, NamedTuples, lists, modules, optimizers,
tensors, the replay buffer) becomes a payload of plain dicts, lists,
tensors and numbers (``to_payload``): a module is its ``state_dict``, an
optimizer its ``state_dict``, a generator its ``get_state()``. So
``torch.load(weights_only=True)`` reads it back without unpickling any
class. ``load_payload`` checks the payload's structure against a live state
of the same runner first (every key, length and tensor shape) and raises
``ValueError`` before touching anything when they differ; then it copies
the payload in, onto the live state's device. Objects shared by several
agents (``share_param``) appear once in a state, so they are saved once.

Each ``ckpt_<step>`` is a directory holding ``state.pt``.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Any, Optional

import torch
from torch import nn

STATE_FILE = "state.pt"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _has_state_dict(x) -> bool:
    return hasattr(x, "state_dict") and hasattr(x, "load_state_dict")


def _fields(x) -> dict:
    """The attributes of a dataclass or plain object, by name."""
    if dataclasses.is_dataclass(x):
        return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    return dict(vars(x))


def to_payload(x: Any) -> Any:
    """A live state → plain dicts, lists, tensors and numbers."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    if isinstance(x, torch.Generator):
        return x.get_state()
    if isinstance(x, nn.Module) or _has_state_dict(x):
        return x.state_dict()
    if _is_namedtuple(x):
        return {k: to_payload(v) for k, v in x._asdict().items()}
    if isinstance(x, (list, tuple)):
        return [to_payload(v) for v in x]
    if isinstance(x, dict):
        return {k: to_payload(v) for k, v in x.items()}
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    return {k: to_payload(v) for k, v in _fields(x).items()}


def _mismatch(where: str, why: str) -> ValueError:
    return ValueError(f"checkpoint does not fit the live state at {where or 'the root'}: {why}")


def _check_tensor(live: torch.Tensor, saved, where: str) -> None:
    if not isinstance(saved, torch.Tensor):
        raise _mismatch(where, f"expected a tensor, found {type(saved).__name__}")
    if saved.shape != live.shape or saved.dtype != live.dtype:
        raise _mismatch(where, f"{tuple(saved.shape)} {saved.dtype} against "
                               f"{tuple(live.shape)} {live.dtype}")


def _check_keys(live: dict, saved, where: str) -> None:
    if not isinstance(saved, dict) or set(saved) != set(live):
        got = sorted(saved) if isinstance(saved, dict) else type(saved).__name__
        raise _mismatch(where, f"keys {got} against {sorted(live)}")


def check_payload(live: Any, saved: Any, where: str = "") -> None:
    """Raise ``ValueError`` where ``saved`` does not fit ``live``."""
    if isinstance(live, torch.Tensor):
        _check_tensor(live, saved, where)
    elif isinstance(live, torch.Generator):
        if not isinstance(saved, torch.Tensor):
            raise _mismatch(where, "expected a generator state")
    elif isinstance(live, nn.Module):
        ref = live.state_dict()
        _check_keys(ref, saved, where)
        for k, v in ref.items():
            _check_tensor(v, saved[k], f"{where}.{k}")
    elif _has_state_dict(live):
        if not isinstance(saved, dict) or _groups(live.state_dict()) != _groups(saved):
            raise _mismatch(where, "an optimizer over other parameter groups")
    elif _is_namedtuple(live):
        check_payload(live._asdict(), saved, where)
    elif isinstance(live, (list, tuple)):
        if not isinstance(saved, list) or len(saved) != len(live):
            raise _mismatch(where, "a list of another length")
        for i, (a, b) in enumerate(zip(live, saved)):
            check_payload(a, b, f"{where}[{i}]")
    elif isinstance(live, dict):
        _check_keys(live, saved, where)
        for k in live:
            check_payload(live[k], saved[k], f"{where}.{k}")
    elif live is None or isinstance(live, (bool, int, float, str)):
        if (live is None) != (saved is None):
            raise _mismatch(where, f"{saved!r} against {live!r}")
    else:
        check_payload(_fields(live), saved, where)


def _groups(sd) -> list:
    """An optimizer state's parameter count per group (the parameters' shapes
    are checked through their modules)."""
    sd = sd.get("adam", sd)
    return [len(g["params"]) for g in sd.get("param_groups", ())]


def load_payload(live: Any, saved: Any) -> Any:
    """Copy ``saved`` into ``live`` (checked first); returns the live state.
    Modules, optimizers, generators, dataclasses and objects are loaded in
    place; tensors are replaced, except leaves that require grad (an
    optimizer holds them), which are copied into."""
    check_payload(live, saved)
    return _load(live, saved)


def _load(live: Any, saved: Any) -> Any:
    if isinstance(live, torch.Tensor):
        if live.requires_grad:
            with torch.no_grad():
                live.copy_(saved)
            return live
        return saved.to(live.device)
    if isinstance(live, torch.Generator):
        live.set_state(saved.cpu())
        return live
    if isinstance(live, nn.Module):
        live.load_state_dict(saved)
        return live
    if isinstance(live, torch.optim.Optimizer):
        live.load_state_dict(steps_on_cpu(live, saved))
        return live
    if _has_state_dict(live):
        live.load_state_dict(saved)
        return live
    if _is_namedtuple(live):
        return type(live)(**{k: _load(v, saved[k]) for k, v in live._asdict().items()})
    if isinstance(live, (list, tuple)):
        return type(live)(_load(a, b) for a, b in zip(live, saved))
    if isinstance(live, dict):
        return {k: _load(v, saved[k]) for k, v in live.items()}
    if live is None or isinstance(live, (bool, int, float, str)):
        return saved
    for k, v in _fields(live).items():
        setattr(live, k, _load(v, saved[k]))
    return live


def steps_on_cpu(opt: torch.optim.Optimizer, sd: dict) -> dict:
    """``sd`` (a state dict of ``opt``) with its step counts on the CPU,
    where torch keeps them for an optimizer that is neither capturable nor
    fused: a payload restored onto the card brings them there, and Adam
    then reads a count on the card with a host sync a parameter a step."""
    if any(g.get("capturable") or g.get("fused") for g in opt.param_groups):
        return sd
    state = {k: {**v, "step": v["step"].cpu()} if torch.is_tensor(v.get("step")) else v
             for k, v in sd.get("state", {}).items()}
    return {**sd, "state": state}


def save_state(save_dir: str, payload: dict, step: int = 0) -> str:
    """Write ``payload`` as ``save_dir/ckpt_<step>/state.pt``; returns the
    checkpoint's directory."""
    path = os.path.abspath(os.path.join(save_dir, f"ckpt_{step}"))
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    return path


def restore_state(path: str, device: torch.device) -> dict:
    """The payload of the checkpoint directory ``path``, on ``device``."""
    return torch.load(os.path.join(path, STATE_FILE), map_location=device, weights_only=True)


def restore_params_into(path: str, state: Any, device: torch.device) -> Any:
    """Params-only restore of an on-policy state, the reference's own
    ``model_dir`` semantics (on_policy_base_runner.py:742-763): every actor
    network, the critic network and the ValueNorm statistics (which must stay
    consistent with the restored critic head) are grafted onto the fresh
    ``state``; optimizers, the env carry and the generator stay fresh. This
    is the transfer case, where the full resume found a structure mismatch."""
    saved = restore_state(path, device)["state"]
    for st, s in zip(state.actors, saved["actors"]):
        st.net.load_state_dict(s["net"])
    state.critic.net.load_state_dict(saved["critic"]["net"])
    if state.value_norm is not None and saved.get("value_norm") is not None:
        state.value_norm = load_payload(state.value_norm, saved["value_norm"])
    return state


def latest_checkpoint(save_dir: str) -> Optional[str]:
    """Newest ``ckpt_<step>`` under ``save_dir``, or under ``save_dir/models``
    (a run directory, the path ``train.py`` prints)."""
    if not os.path.isdir(save_dir):
        return None
    ckpts = [d for d in os.listdir(save_dir) if d.startswith("ckpt_")]
    if not ckpts:
        models = os.path.join(save_dir, "models")
        return latest_checkpoint(models) if os.path.isdir(models) else None
    return os.path.join(save_dir, max(ckpts, key=lambda d: int(d.split("_")[1])))


def prune_checkpoints(save_dir: str, keep: int = 2) -> None:
    """Delete all but the newest ``keep`` (at least one) checkpoints: an
    off-policy state holds its replay buffer."""
    if not os.path.isdir(save_dir):
        return
    ckpts = sorted((d for d in os.listdir(save_dir) if d.startswith("ckpt_")),
                   key=lambda d: int(d.split("_")[1]))
    for d in ckpts[:-max(keep, 1)]:
        shutil.rmtree(os.path.join(save_dir, d), ignore_errors=True)
