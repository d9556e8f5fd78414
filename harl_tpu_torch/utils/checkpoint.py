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

A tensor that is the whole of a storage no other tensor of the live state
shares (the replay ring's columns) is restored in place: the saved bytes
are copied into it, so a resume allocates nothing of its size on the
device. ``restore_state`` reads the file as memory-mapped CPU tensors, so
the payload holds no second copy of the state on the device either; a
resume of a state of G bytes then peaks at G on the card
(``torch.load(map_location=device)`` with tensors replaced peaked at 2G).
A copy from the host onto the card goes through two pinned buffers of
``STAGE_BYTES`` (``copy_to_device``): a copy straight from the mapped,
pageable file moved 2-2.5x slower on an H100's host (``chip_smoke.py``
phase 23 times both).

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
# each of the two pinned buffers a host-to-card copy is staged through
STAGE_BYTES = 64 * 2 ** 20


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
    place. A tensor is copied into where it requires grad (an optimizer
    holds it) or owns its storage alone (``sole_owners``); any other is
    replaced by a copy of the saved one on its device."""
    check_payload(live, saved)
    return _load(live, saved, sole_owners(live))


def _storage_key(t: torch.Tensor) -> tuple:
    return t.device, t.untyped_storage().data_ptr()


def sole_owners(live: Any) -> set:
    """The storage keys of the live state's tensors that are the whole of a
    storage no other tensor of the state shares: every tensor of its
    payload (``to_payload``: modules' parameters and buffers, optimizer
    moments, each leaf) is counted by storage, so a copy into one of these
    writes no other tensor of the state, and no two copies write one
    storage. Empty tensors are left out (they share the null pointer)."""
    counts: dict = {}
    whole = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            key = _storage_key(x)
            counts[key] = counts.get(key, 0) + 1
            if (x.numel() and x.is_contiguous() and x.storage_offset() == 0
                    and x.untyped_storage().nbytes() == x.numel() * x.element_size()):
                whole.add(key)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(to_payload(live))
    return {k for k in whole if counts[k] == 1}


def copy_to_device(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``; from a host tensor into a contiguous one on a CUDA
    card larger than one stage, through two pinned buffers of
    ``STAGE_BYTES`` in turn: each chunk is copied on the host into one
    while the card copies the other, and nothing of ``dst``'s size is
    allocated."""
    if not (dst.is_cuda and src.device.type == "cpu" and dst.is_contiguous()
            and dst.nbytes > STAGE_BYTES):
        dst.copy_(src)
        return
    a = dst.view(-1).view(torch.uint8)
    b = src.contiguous().view(-1).view(torch.uint8)
    stages = [torch.empty(STAGE_BYTES, dtype=torch.uint8, pin_memory=True) for _ in range(2)]
    done = [None, None]
    for k, lo in enumerate(range(0, a.numel(), STAGE_BYTES)):
        i, n = k % 2, min(STAGE_BYTES, a.numel() - lo)
        if done[i] is not None:
            done[i].synchronize()      # the card has read this stage
        stages[i][:n].copy_(b[lo:lo + n])
        a[lo:lo + n].copy_(stages[i][:n], non_blocking=True)
        done[i] = torch.cuda.Event()
        done[i].record()
    for ev in done:
        if ev is not None:
            ev.synchronize()


def _load(live: Any, saved: Any, owners: set) -> Any:
    if isinstance(live, torch.Tensor):
        if live.requires_grad or _storage_key(live) in owners:
            with torch.no_grad():
                copy_to_device(live, saved)
            return live
        return saved.to(live.device, copy=True)
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
        return type(live)(**{k: _load(v, saved[k], owners)
                             for k, v in live._asdict().items()})
    if isinstance(live, (list, tuple)):
        return type(live)(_load(a, b, owners) for a, b in zip(live, saved))
    if isinstance(live, dict):
        return {k: _load(v, saved[k], owners) for k, v in live.items()}
    if live is None or isinstance(live, (bool, int, float, str)):
        return saved
    for k, v in _fields(live).items():
        setattr(live, k, _load(v, saved[k], owners))
    return live


def steps_on_cpu(opt: torch.optim.Optimizer, sd: dict) -> dict:
    """``sd`` (a state dict of ``opt``) with its step counts on the CPU,
    where torch keeps them for an optimizer that is neither capturable nor
    fused: a payload restored onto the card brings them there, and Adam
    then reads a count on the card with a host sync a parameter a step.
    Every tensor of its state that lies on the CPU is a copy of its own,
    so that nothing loaded from a memory-mapped payload keeps the file
    mapped (the file of a replay ring may be pruned while the run goes on)."""
    device_steps = any(g.get("capturable") or g.get("fused") for g in opt.param_groups)

    def own(key, v):
        if not torch.is_tensor(v):
            return v
        if key == "step" and not device_steps:
            return v.to("cpu", copy=True)
        return v.clone() if v.device.type == "cpu" else v

    state = {k: {key: own(key, t) for key, t in v.items()}
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


def restore_state(path: str) -> dict:
    """The payload of the checkpoint directory ``path``, as CPU tensors
    mapped from the file: read as ``load_payload`` copies them onto the live
    state's device, nothing of the state's size allocated there."""
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu", mmap=True,
                      weights_only=True)


def restore_params_into(path: str, state: Any) -> Any:
    """Params-only restore of an on-policy state, the reference's own
    ``model_dir`` semantics (on_policy_base_runner.py:742-763): every actor
    network, the critic network and the ValueNorm statistics (which must stay
    consistent with the restored critic head) are grafted onto the fresh
    ``state``; optimizers, the env carry and the generator stay fresh. This
    is the transfer case, where the full resume found a structure mismatch."""
    saved = restore_state(path)["state"]
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
