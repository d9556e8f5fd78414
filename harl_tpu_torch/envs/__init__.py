"""Environment registry (counterpart of ``harl_tpu/envs/__init__.py``).

Every pure-tensor env of the JAX package, routed as it routes them: the
``mamujoco_jax`` scenarios (``manyagent_swimmer``/``Swimmer-v2``,
``coupled_half_cheetah``, Humanoid and HumanoidStandup, ``Reacher*``,
``manyagent_ant``, Ant, and the planar HalfCheetah, Walker2d and Hopper;
another name raises ``ValueError``), the Bi-DexterousHands family under
``dexhands_jax`` and ``dexhands`` (the catch tasks of ``handover.py``, the
hinge and table tasks of ``manip.py``), the MPE scenarios under
``pettingzoo_mpe``/``mpe`` (reference names with their ``_v2``/``_v3``
suffix accepted), SMACLite under ``smaclite``, ``smac`` and ``smacv2`` (the
fixed compositions and SMACv2's randomized maps), academy soccer under
``football_jax``/``soccer`` and air combat under ``lag_jax``/``aircombat``.
``smac`` and ``smacv2`` run SMACLite as the JAX package does when the
StarCraft II packages are missing, and ``dexhands`` the tensor hands where
IsaacGym is missing; ``backend: native`` (the real game, IsaacGym) and the
host envs (``HOST_ENVS``) raise ``NotImplementedError`` naming the tooling
item; an unknown name raises ``ValueError``.
"""
from __future__ import annotations

from harl_tpu_torch.utils.device import DeviceLike, resolve_device

# the host-stepped envs of the JAX package (gfootball, JSBSim, MuJoCo, gym)
HOST_ENVS = ("football", "lag", "mamujoco", "gym")


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
        # the JAX package's order (harl_tpu/envs/__init__.py:50-82)
        scenario = env_args.get("scenario", "manyagent_swimmer")  # the JAX default
        device = resolve_device(device)
        if scenario in ("manyagent_swimmer", "Swimmer-v2"):
            from harl_tpu_torch.envs.mamujoco_jax.swimmer import make_swimmer

            return make_swimmer(env_args, device)
        if scenario == "coupled_half_cheetah":
            from harl_tpu_torch.envs.mamujoco_jax.coupled import make_coupled

            return make_coupled(env_args, device)
        if scenario.startswith("Humanoid"):
            from harl_tpu_torch.envs.mamujoco_jax.humanoid import make_humanoid

            return make_humanoid(env_args, device)
        if scenario.startswith("Reacher"):
            from harl_tpu_torch.envs.mamujoco_jax.reacher import make_reacher

            return make_reacher(env_args, device)
        if scenario == "manyagent_ant":
            from harl_tpu_torch.envs.mamujoco_jax.manyagent_ant import make_manyagent_ant

            return make_manyagent_ant(env_args, device)
        if scenario.startswith("Ant"):
            from harl_tpu_torch.envs.mamujoco_jax.ant import make_ant

            return make_ant(env_args, device)
        # planar HalfCheetah, Walker2d and Hopper; another name raises ValueError
        from harl_tpu_torch.envs.mamujoco_jax.planar import make_planar

        return make_planar(env_args, device)
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
    if env_name in ("dexhands", "dexhands_jax"):
        if env_name == "dexhands" and env_args.get("backend", "auto") == "native":
            raise NotImplementedError(
                "dexhands backend 'native' (IsaacGym's Bi-DexterousHands): the port has no "
                "host-env runner path yet (ROADMAP.md, tooling)")
        from harl_tpu_torch.envs.dexhands_jax.manip import MANIP_TASKS

        if env_args.get("task", "ShadowHandOver") in MANIP_TASKS:
            from harl_tpu_torch.envs.dexhands_jax.manip import make_manip

            return make_manip(env_args, resolve_device(device))
        from harl_tpu_torch.envs.dexhands_jax.handover import make_handover

        return make_handover(env_args, resolve_device(device))
    if env_name in ("football_jax", "soccer"):
        from harl_tpu_torch.envs.football_jax.soccer import make_soccer

        return make_soccer(env_args, resolve_device(device))
    if env_name in ("lag_jax", "aircombat"):
        from harl_tpu_torch.envs.lag_jax.aircombat import make_aircombat

        return make_aircombat(env_args, resolve_device(device))
    if env_name in HOST_ENVS:
        raise NotImplementedError(
            f"host env {env_name!r}: the port has no host-env runner path yet "
            "(ROADMAP.md, tooling)")
    raise ValueError(f"Unknown env {env_name!r}")
