"""Environment registry (counterpart of ``harl_tpu/envs/__init__.py``).

Ported: the ``mamujoco_jax`` scenarios HalfCheetah, Walker2d, Hopper (planar)
and Ant (3D), the MPE scenarios under ``pettingzoo_mpe``/``mpe`` (reference
names with their ``_v2``/``_v3`` suffix accepted), and the pure-tensor
SMACLite under ``smaclite``, ``smac`` and ``smacv2``: the fixed
compositions and SMACv2's randomized maps. ``smac`` and ``smacv2`` run
SMACLite as the JAX package does when the StarCraft II packages are missing;
``backend: native`` (the real game) raises. Every other env raises
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
        if scenario.startswith("Ant"):
            from harl_tpu_torch.envs.mamujoco_jax.ant import make_ant

            return make_ant(env_args, resolve_device(device))
        raise NotImplementedError(
            f"mamujoco_jax scenario {scenario!r} is not ported yet "
            "(ROADMAP.md, remaining pure-JAX envs)")
    if env_name in ("smaclite", "smac", "smacv2"):
        from harl_tpu_torch.envs.smaclite.smaclite import make_smaclite

        if env_name != "smaclite" and env_args.get("backend", "auto") == "native":
            raise NotImplementedError(
                f"{env_name} backend 'native' (the StarCraft II game): the port has no "
                "host-env runner path yet (ROADMAP.md, tooling)")

        kwargs = {k: env_args[k] for k in ("episode_limit", "state_type", "reward_scale")
                  if k in env_args}
        return make_smaclite(env_args.get("map_name", "5m_vs_5m"), resolve_device(device),
                             **kwargs)
    raise NotImplementedError(
        f"env {env_name!r} is not ported yet (ROADMAP.md, the remaining pure-JAX "
        "envs, tooling)")
