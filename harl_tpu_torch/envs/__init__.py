"""Environment registry (counterpart of ``harl_tpu/envs/__init__.py``).

Every env of the JAX package, routed as it routes them. The pure-tensor
envs, built on ``device``: the ``mamujoco_jax`` scenarios
(``manyagent_swimmer``/``Swimmer-v2``, ``coupled_half_cheetah``, Humanoid
and HumanoidStandup, ``Reacher*``, ``manyagent_ant``, Ant, and the planar
HalfCheetah, Walker2d and Hopper; another name raises ``ValueError``), the
Bi-DexterousHands family under ``dexhands_jax`` and ``dexhands`` (the catch
tasks of ``handover.py``, the hinge and table tasks of ``manip.py``), the
MPE scenarios under ``pettingzoo_mpe``/``mpe`` (reference names with their
``_v2``/``_v3`` suffix accepted), SMACLite under ``smaclite``, ``smac`` and
``smacv2`` (the fixed compositions and SMACv2's randomized maps), academy
soccer under ``football_jax``/``soccer`` and air combat under
``lag_jax``/``aircombat``.

The host envs (``is_jax`` false; NumPy in, NumPy out, ``envs/host.py``):
``mamujoco`` (the native vec-MuJoCo engine under ``backend`` ``auto`` or
``native``, gymnasium's tasks where ``auto`` cannot build it), ``gym``,
``football`` and ``lag``, and under ``backend: native`` (or ``auto``, where
the package imports) the real games behind ``smac``, ``smacv2`` and
``dexhands``. ``backend: native`` raises the adapter's ``ImportError`` where
its package is missing; ``auto`` then falls back to the tensor env. The
device is not read by a host env: its runner moves the arrays. An unknown
name raises ``ValueError``.
"""
from __future__ import annotations

import importlib.util

from harl_tpu_torch.utils.device import DeviceLike, resolve_device

# env names make_env always builds as host envs, and the package of the real
# game that backend auto or native builds instead of a tensor env
HOST_ENV_NAMES = ("mamujoco", "gym", "football", "lag")
ADAPTER_PACKAGES = {"smac": "smac", "smacv2": "smacv2", "dexhands": "isaacgym"}


def is_host_env(env_name: str, env_args: dict) -> bool:
    """Whether ``make_env`` builds a host env for these arguments, told
    without building one (under backend ``auto``, by whether the real
    game's package can be found)."""
    if env_name in HOST_ENV_NAMES:
        return True
    backend = env_args.get("backend", "auto")
    if env_name not in ADAPTER_PACKAGES or backend not in ("auto", "native"):
        return False
    return backend == "native" or importlib.util.find_spec(ADAPTER_PACKAGES[env_name]) is not None


def make_env(env_name: str, env_args: dict, device: DeviceLike = None):
    """Construct a batched tensor env on ``device`` (CUDA unless given), or
    a host env."""
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
        # smac and smacv2 prefer the real StarCraft II game where its package
        # imports (backend auto or native), as the mamujoco native engine;
        # else SMACLite runs the same maps. backend jax forces SMACLite.
        backend = env_args.get("backend", "auto")
        if env_name != "smaclite" and backend in ("auto", "native"):
            try:
                if env_name == "smac":
                    from harl_tpu_torch.envs.smac.smac_env import make_smac

                    return make_smac(env_args)
                from harl_tpu_torch.envs.smacv2.smacv2_env import make_smacv2

                return make_smacv2(env_args)
            except ImportError:
                if backend == "native":
                    raise
        from harl_tpu_torch.envs.smaclite.smaclite import make_smaclite

        kwargs = {k: env_args[k] for k in ("episode_limit", "state_type", "reward_scale")
                  if k in env_args}
        return make_smaclite(env_args.get("map_name", "5m_vs_5m"), resolve_device(device),
                             **kwargs)
    if env_name in ("dexhands", "dexhands_jax"):
        backend = env_args.get("backend", "auto")
        if env_name == "dexhands" and backend in ("auto", "native"):
            # the real IsaacGym Bi-DexterousHands where it imports (CUDA only)
            try:
                from harl_tpu_torch.envs.dexhands.dexhands_env import make_dexhands

                return make_dexhands(env_args)
            except ImportError:
                if backend == "native":
                    raise
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
    if env_name == "mamujoco":
        backend = env_args.get("backend", "auto")
        if backend in ("auto", "native"):
            try:
                from harl_tpu_torch.envs.mamujoco.native_vec import make_native_mamujoco

                return make_native_mamujoco(env_args)
            except (ImportError, ValueError, RuntimeError):
                if backend == "native":
                    raise
        from harl_tpu_torch.envs.mamujoco.mamujoco import make_mamujoco

        return make_mamujoco(env_args)
    if env_name == "gym":
        from harl_tpu_torch.envs.gym.gym_env import make_gym

        return make_gym(env_args)
    if env_name == "football":
        from harl_tpu_torch.envs.football.football_env import FootballEnv

        return FootballEnv(env_args)
    if env_name == "lag":
        from harl_tpu_torch.envs.lag.lag_env import LAGEnv

        return LAGEnv(env_args)
    raise ValueError(f"Unknown env {env_name!r}")
