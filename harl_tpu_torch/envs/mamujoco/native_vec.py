"""Vectorized MAMuJoCo on the native C++ engine, no subprocesses
(counterpart of ``harl_tpu/envs/mamujoco/native_vec.py``).

Replaces the reference's ``ShareSubprocVecEnv`` (one OS process and Pipe
round-trip per env per step, ``harl/envs/env_wrappers.py:220-295``) with the
in-process thread-pool stepper of ``harl_tpu_torch/native/vec_mujoco.cc``:
one ``mjModel``, N ``mjData``, every env stepped by one C call a control
step. The task layer (observation, reward, termination, reset noise) is
computed vectorized in NumPy from the raw (qpos, qvel) batch.

Task rules follow gymnasium's public MuJoCo envs (the tasks the reference's
MAMuJoCo wraps): HalfCheetah, Walker2d and Hopper exactly, and Ant and
Humanoid with forward velocity + healthy + control cost, whose observation
is the kinematic state qpos[2:] + qvel rather than gymnasium's extended
cfrc/cinert vectors (as in the JAX package).

Agents and observations follow ``mamujoco.py``: contiguous actuator
partitions by ``agent_conf``; agent obs = standardized concat(state, one-hot
id); share_obs = the raw state; the team reward; truncation at
``episode_limit`` sets ``bad_transition``. Resets draw from a NumPy
``default_rng`` seeded by ``ensure_envs`` (1 unless given) or ``seed``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import pathlib
from typing import Optional

import numpy as np

from harl_tpu_torch.envs.mamujoco.mamujoco import act_slices
from harl_tpu_torch.utils import spaces


@dataclasses.dataclass(frozen=True)
class TaskRules:
    xml: str
    frame_skip: int
    obs_skip: int                 # leading qpos entries left out of the obs
    ctrl_scale: float             # action [-1, 1] → ctrl range
    forward_reward_weight: float
    ctrl_cost_weight: float
    healthy_reward: float
    terminate_when_unhealthy: bool
    healthy_z_index: int          # qpos index holding the height
    healthy_z_range: tuple
    healthy_angle_index: Optional[int] = None
    healthy_angle_range: tuple = (-np.inf, np.inf)
    healthy_state_range: tuple = (-np.inf, np.inf)
    clip_qvel_obs: float = 0.0
    reset_noise: float = 5e-3
    reset_qvel_normal: bool = False


RULES = {
    "HalfCheetah": TaskRules(
        xml="half_cheetah.xml", frame_skip=5, obs_skip=1, ctrl_scale=1.0,
        forward_reward_weight=1.0, ctrl_cost_weight=0.1, healthy_reward=0.0,
        terminate_when_unhealthy=False, healthy_z_index=1,
        healthy_z_range=(-np.inf, np.inf),
        reset_noise=0.1, reset_qvel_normal=True),
    "Walker2d": TaskRules(
        xml="walker2d_v5.xml", frame_skip=4, obs_skip=1, ctrl_scale=1.0,
        forward_reward_weight=1.0, ctrl_cost_weight=1e-3, healthy_reward=1.0,
        terminate_when_unhealthy=True, healthy_z_index=1,
        healthy_z_range=(0.8, 2.0), healthy_angle_index=2,
        healthy_angle_range=(-1.0, 1.0), clip_qvel_obs=10.0),
    "Hopper": TaskRules(
        xml="hopper.xml", frame_skip=4, obs_skip=1, ctrl_scale=1.0,
        forward_reward_weight=1.0, ctrl_cost_weight=1e-3, healthy_reward=1.0,
        terminate_when_unhealthy=True, healthy_z_index=1,
        healthy_z_range=(0.7, np.inf), healthy_angle_index=2,
        healthy_angle_range=(-0.2, 0.2), healthy_state_range=(-100.0, 100.0),
        clip_qvel_obs=10.0),
    "Ant": TaskRules(
        xml="ant.xml", frame_skip=5, obs_skip=2, ctrl_scale=1.0,
        forward_reward_weight=1.0, ctrl_cost_weight=0.5, healthy_reward=1.0,
        terminate_when_unhealthy=True, healthy_z_index=2,
        healthy_z_range=(0.2, 1.0), reset_noise=0.1, reset_qvel_normal=True),
    "Humanoid": TaskRules(
        xml="humanoid.xml", frame_skip=5, obs_skip=2, ctrl_scale=0.4,
        forward_reward_weight=1.25, ctrl_cost_weight=0.1, healthy_reward=5.0,
        terminate_when_unhealthy=True, healthy_z_index=2,
        healthy_z_range=(1.0, 2.0), reset_noise=0.01),
}


def _asset_path(xml: str) -> str:
    import gymnasium.envs.mujoco as m

    return str(pathlib.Path(m.__file__).resolve().parent / "assets" / xml)


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class NativeMAMuJoCoVec:
    """A pre-vectorized host env: ``ensure_envs(n)`` sizes the batch, then
    ``reset``/``step`` follow ``HostVecEnv``'s batch interface."""

    is_jax = False
    is_vectorized = True

    def __init__(self, env_args: dict):
        from harl_tpu_torch.native.build import load

        scenario = env_args.get("scenario", "HalfCheetah-v2").split("-")[0]
        if scenario not in RULES:
            raise ValueError(f"native MAMuJoCo: unsupported scenario {scenario!r}; "
                             f"available: {sorted(RULES)}")
        self.lib = load()
        self.rules = RULES[scenario]
        self.scenario = scenario
        self.agent_conf = env_args.get("agent_conf", "6x1")
        self.episode_limit = env_args.get("episode_limit", 1000)
        self.n_threads_cpp = int(env_args.get("native_threads", 8))
        self._xml = _asset_path(self.rules.xml)

        # the model's sizes, from a one-env engine
        h = self.lib.vmj_create(self._xml.encode(), 1, 1)
        if not h:
            raise RuntimeError(f"mj_loadXML failed for {self._xml}")
        self.nq, self.nv, self.nu = self.lib.vmj_nq(h), self.lib.vmj_nv(h), self.lib.vmj_nu(h)
        self.dt = self.lib.vmj_timestep(h) * self.rules.frame_skip
        self._qpos0 = np.zeros(self.nq)
        self.lib.vmj_qpos0(h, _dp(self._qpos0))
        self.lib.vmj_destroy(h)
        self.h = None
        self.n_envs = 0

        self.n_agents, sizes, self._act_slices = act_slices(self.nu, self.agent_conf)
        self.state_dim = (self.nq - self.rules.obs_skip) + self.nv
        self.observation_space = [spaces.Box.create(-10.0, 10.0, self.state_dim + self.n_agents)
                                  for _ in range(self.n_agents)]
        self.share_observation_space = [spaces.Box.create(-10.0, 10.0, self.state_dim)
                                        for _ in range(self.n_agents)]
        self.action_space = [spaces.Box.create(-1.0, 1.0, s) for s in sizes]
        self._rng = np.random.default_rng(1)

    # ------------------------------------------------------------ lifecycle
    def ensure_envs(self, n_envs: int, seed: int = 1) -> None:
        """An engine of ``n_envs`` envs (kept if it has that many), its
        reset generator seeded with ``seed``."""
        if self.h is not None and self.n_envs == n_envs:
            return
        if self.h is not None:
            self.lib.vmj_destroy(self.h)
        self.h = self.lib.vmj_create(self._xml.encode(), n_envs,
                                     min(self.n_threads_cpp, n_envs))
        if not self.h:
            raise RuntimeError(f"vmj_create failed for {self._xml}")
        self.n_envs = n_envs
        self.steps = np.zeros(n_envs, np.int64)
        self._qpos = np.zeros((n_envs, self.nq))
        self._qvel = np.zeros((n_envs, self.nv))
        self._rng = np.random.default_rng(seed)

    def seed(self, seed: int) -> None:
        self._rng = np.random.default_rng(seed)

    def _reset_env(self, i: int) -> None:
        r = self.rules
        qpos = self._qpos0 + self._rng.uniform(-r.reset_noise, r.reset_noise, self.nq)
        if r.reset_qvel_normal:
            qvel = r.reset_noise * self._rng.standard_normal(self.nv)
        else:
            qvel = self._rng.uniform(-r.reset_noise, r.reset_noise, self.nv)
        self.lib.vmj_set_state(self.h, i, _dp(qpos), _dp(np.ascontiguousarray(qvel)))
        self.steps[i] = 0

    # ------------------------------------------------------------------ api
    def reset(self):
        if self.h is None:
            raise RuntimeError("call ensure_envs(n) first")
        for i in range(self.n_envs):
            self._reset_env(i)
        self._pull_state()
        return self._obs(), self._state_vec(), None

    def _pull_state(self) -> None:
        self.lib.vmj_get_state(self.h, _dp(self._qpos), _dp(self._qvel))

    def step(self, actions: np.ndarray) -> dict:
        """``actions`` (n_envs, n_agents, max act width) in [-1, 1] → the
        ``HostVecEnv.step`` dict."""
        r = self.rules
        ctrl = np.zeros((self.n_envs, self.nu))
        for a, (s, e) in enumerate(self._act_slices):
            ctrl[:, s:e] = np.asarray(actions)[:, a, : e - s]
        ctrl = np.clip(ctrl, -1.0, 1.0) * r.ctrl_scale
        x_before = self._qpos[:, 0].copy()
        self.lib.vmj_step(self.h, _dp(np.ascontiguousarray(ctrl)), r.frame_skip, None)
        self._pull_state()
        self.steps += 1

        vel = (self._qpos[:, 0] - x_before) / self.dt
        ctrl_cost = np.sum(np.clip(ctrl / max(r.ctrl_scale, 1e-8), -1, 1) ** 2, axis=1)
        healthy = self._healthy()
        reward = (r.forward_reward_weight * vel - r.ctrl_cost_weight * ctrl_cost
                  + r.healthy_reward * (healthy if r.terminate_when_unhealthy else 1.0))
        term = ~healthy if r.terminate_when_unhealthy else np.zeros(self.n_envs, bool)
        trunc = self.steps >= self.episode_limit
        done = term | trunc
        bad = trunc & ~term

        final_state = self._state_vec()
        final_obs = self._obs()
        # auto-reset the finished envs; the fresh obs replace the terminal ones
        for i in np.nonzero(done)[0]:
            self._reset_env(i)
        if done.any():
            self._pull_state()
        infos = [[{"bad_transition": bool(bad[i])}] * self.n_agents for i in range(self.n_envs)]
        return dict(
            obs=self._obs().astype(np.float32),
            share_obs=self._state_vec().astype(np.float32),
            rewards=np.repeat(reward[:, None, None], self.n_agents, axis=1).astype(np.float32),
            dones=np.repeat(done[:, None], self.n_agents, axis=1),
            infos=infos,
            available_actions=None,
            final_obs=final_obs.astype(np.float32),
            final_share_obs=final_state.astype(np.float32),
        )

    # -------------------------------------------------------------- helpers
    def _healthy(self) -> np.ndarray:
        r = self.rules
        z = self._qpos[:, r.healthy_z_index]
        ok = (z > r.healthy_z_range[0]) & (z < r.healthy_z_range[1])
        if r.healthy_angle_index is not None:
            a = self._qpos[:, r.healthy_angle_index]
            ok &= (a > r.healthy_angle_range[0]) & (a < r.healthy_angle_range[1])
        if np.isfinite(r.healthy_state_range[1]):
            ok &= np.all(np.abs(self._state_vec()) < r.healthy_state_range[1], axis=1)
        ok &= np.all(np.isfinite(self._qpos), axis=1)
        return ok

    def _state_vec(self) -> np.ndarray:
        qv = self._qvel
        if self.rules.clip_qvel_obs > 0:
            qv = np.clip(qv, -self.rules.clip_qvel_obs, self.rules.clip_qvel_obs)
        return np.concatenate([self._qpos[:, self.rules.obs_skip:], qv], axis=1)

    def _obs(self) -> np.ndarray:
        sv = self._state_vec()                               # (B, S)
        B, N = self.n_envs, self.n_agents
        ids = np.broadcast_to(np.eye(N), (B, N, N))
        o = np.concatenate([np.repeat(sv[:, None, :], N, axis=1), ids], axis=2)
        return (o - o.mean(axis=2, keepdims=True)) / (o.std(axis=2, keepdims=True) + 1e-8)

    def close(self) -> None:
        if self.h is not None:
            self.lib.vmj_destroy(self.h)
            self.h = None


def make_native_mamujoco(env_args: dict) -> NativeMAMuJoCoVec:
    return NativeMAMuJoCoVec(env_args)
