"""Environment registry (counterpart of ``harl_tpu/envs/__init__.py``).

Only the planar ``mamujoco_jax`` scenarios are ported; every other env raises
``NotImplementedError`` naming its roadmap item.
"""
from __future__ import annotations

from harl_tpu_torch.utils.device import DeviceLike, resolve_device


def make_env(env_name: str, env_args: dict, device: DeviceLike = None):
    """Construct a batched tensor env on ``device`` (CUDA unless given)."""
    if env_name in ("mamujoco_jax", "manyagent_swimmer"):
        scenario = env_args.get("scenario", "manyagent_swimmer")  # the JAX default
        if scenario.split("-")[0] in ("HalfCheetah", "Walker2d", "Hopper"):
            from harl_tpu_torch.envs.mamujoco_jax.planar import make_planar

            return make_planar(env_args, resolve_device(device))
        raise NotImplementedError(
            f"mamujoco_jax scenario {scenario!r} is not ported yet "
            "(ROADMAP.md, remaining pure-JAX envs)")
    raise NotImplementedError(
        f"env {env_name!r} is not ported yet (ROADMAP.md, the recurrent "
        "discrete path, the remaining pure-JAX envs, tooling)")
