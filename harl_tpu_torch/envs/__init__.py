"""Environment registry (counterpart of ``harl_tpu/envs/__init__.py``).

Ported: the planar ``mamujoco_jax`` scenarios (HalfCheetah, Walker2d,
Hopper), the MPE scenarios under ``pettingzoo_mpe``/``mpe`` (reference
names with their ``_v2``/``_v3`` suffix accepted) and the pure-tensor
``smaclite`` maps (fixed compositions). Every other env raises
``NotImplementedError`` naming its roadmap item.
"""
from __future__ import annotations

from harl_tpu_torch.utils.device import DeviceLike, resolve_device


def make_env(env_name: str, env_args: dict, device: DeviceLike = None):
    """Construct a batched tensor env on ``device`` (CUDA unless given)."""
    if env_name in ("pettingzoo_mpe", "mpe"):
        from harl_tpu_torch.envs.mpe.mpe import make_mpe

        scenario = env_args.get("scenario", "simple_spread")
        for suffix in ("_v3", "_v2"):
            if scenario.endswith(suffix):
                scenario = scenario[: -len(suffix)]
        kwargs = {k: env_args[k] for k in ("max_cycles", "local_ratio") if k in env_args}
        return make_mpe(scenario, resolve_device(device),
                        continuous_actions=env_args.get("continuous_actions", True), **kwargs)
    if env_name in ("mamujoco_jax", "manyagent_swimmer"):
        scenario = env_args.get("scenario", "manyagent_swimmer")  # the JAX default
        if scenario.split("-")[0] in ("HalfCheetah", "Walker2d", "Hopper"):
            from harl_tpu_torch.envs.mamujoco_jax.planar import make_planar

            return make_planar(env_args, resolve_device(device))
        raise NotImplementedError(
            f"mamujoco_jax scenario {scenario!r} is not ported yet "
            "(ROADMAP.md, remaining pure-JAX envs)")
    if env_name == "smaclite":
        from harl_tpu_torch.envs.smaclite.smaclite import make_smaclite

        kwargs = {k: env_args[k] for k in ("episode_limit", "state_type", "reward_scale")
                  if k in env_args}
        return make_smaclite(env_args.get("map_name", "5m_vs_5m"), resolve_device(device),
                             **kwargs)
    raise NotImplementedError(
        f"env {env_name!r} is not ported yet (ROADMAP.md, the remaining pure-JAX "
        "envs, tooling)")
