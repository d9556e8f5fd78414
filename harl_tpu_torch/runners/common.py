"""What both runners share: padded action stacking, the deterministic
evaluation loop over auto-reset envs, the seeds of the generators that
evaluation and rendering draw from (so they never move the training
generator), how a runner takes its rank's env columns under data
parallelism, and a host env's arrays on the device."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from harl_tpu_torch.envs.core import TimeStep, VecEnv
from harl_tpu_torch.parallel.mesh import LOCAL, ShardedNoise, tensors_of
from harl_tpu_torch.utils import checkpoint
from harl_tpu_torch.utils.noise import GeneratorNoise

# salts of the evaluation and render generators: the constants the JAX
# runners fold into their keys (on_policy.py:771, 801, 949; off_policy.py:730)
ON_POLICY_EVAL_SALT = 7777
OFF_POLICY_EVAL_SALT = 31337
RENDER_SALT = 4242
HOST_EVAL_SALT = 99


def attach_mesh(runner, mesh) -> None:
    """Point ``runner`` at its rank's env columns of a data-parallel
    ``mesh`` (``parallel/mesh.py``; None: ``LOCAL``, all of them): its
    ``mesh``, its ``n_envs`` local envs, its ``VecEnv``, its env-axis noise
    source and ``env_cols``, the global index of each local env (host
    int64). ``ValueError`` where the ranks do not divide
    ``n_rollout_threads``, as a ``NamedSharding`` of the env axis fails in
    JAX, and for a host env (``runner.host_vec``, stepping every env of the
    run) under more than one rank: the JAX runners ignore the mesh there,
    which would leave unsynchronised replicas."""
    B = runner.n_rollout_threads
    mesh = mesh or LOCAL
    if runner.host_mode and mesh.world > 1:
        raise ValueError(f"host env {runner.args['env']!r}: data parallelism over "
                         f"{mesh.world} ranks needs a tensor env")
    if B % mesh.world:
        raise ValueError(f"n_rollout_threads {B} does not split over {mesh.world} ranks")
    runner.mesh = mesh
    runner.n_envs = B // mesh.world
    runner.noise = ShardedNoise(runner.base_noise, mesh, B)
    lo = mesh.row_range(B)[0]
    runner.env_cols = torch.arange(lo, lo + runner.n_envs)
    runner.vec = runner.host_vec if runner.host_mode else VecEnv(runner.env, runner.n_envs)


def replica_tensors(state, buffer: bool = True) -> List[torch.Tensor]:
    """The tensors of a runner's state that data parallelism keeps equal on
    every rank: networks, targets, optimizer states, α, ValueNorm and (with
    ``buffer``) the replay buffer, in a fixed order; not the env carry."""
    payload = checkpoint.to_payload(state)
    return tensors_of({k: v for k, v in payload.items()
                       if k != "carry" and (buffer or k != "buffer")})


def host_tensor(x, device: torch.device) -> Optional[torch.Tensor]:
    """A host env's NumPy array on ``device`` as float32 (None stays None):
    float64 state rounds as ``jnp.asarray`` rounds it."""
    if x is None:
        return None
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def host_state(share_obs):
    """A host env's EP state (B, ds): agent 0's row where the env gives one
    per agent (B, N, ds), as the real-game adapters do and the reference's
    EP runners store it (``share_obs[:, 0]``). The JAX package's host path
    keeps the agent axis there and fails (ROADMAP Queue C)."""
    return share_obs[:, 0] if np.ndim(share_obs) == 3 else share_obs


def host_timestep(obs, share_obs, avail, device: torch.device) -> TimeStep:
    """A host env's (obs, share_obs, availability) on ``device``."""
    return TimeStep(obs=host_tensor(obs, device),
                    share_obs=host_tensor(host_state(share_obs), device),
                    rewards=None, dones=None, bad_transition=None,
                    available_actions=host_tensor(avail, device))


def stack_actions(acts: List[torch.Tensor]) -> torch.Tensor:
    """Per-agent actions (B, d_i) → (B, N, max d_i), zero-padded."""
    width = max(a.shape[-1] for a in acts)
    return torch.stack([torch.nn.functional.pad(a, (0, width - a.shape[-1])) for a in acts],
                       dim=1)


def derived_noise(seed: int, salt: int, round_idx: int, device: torch.device) -> GeneratorNoise:
    """A noise source on a generator of its own, seeded from the run's seed,
    a salt and a round: a run with evaluation trains exactly as one without."""
    s = ((seed * 1_000_003 + salt) * 1_000_003 + round_idx) % (2 ** 63)
    return GeneratorNoise(torch.Generator(device=device).manual_seed(s), device)


ActFn = Callable[[torch.Tensor, Optional[torch.Tensor], torch.Tensor, object],
                 Tuple[torch.Tensor, object]]


@torch.no_grad()
def eval_rollout(env, n_envs: int, steps: int, noise, act: ActFn, rnn0=None):
    """``steps`` steps of ``n_envs`` auto-reset envs under the deterministic
    policy ``act(obs, avail, masks, rnn) → (stacked actions, rnn)``, counting
    every completed episode (on_policy_base_runner.py:499-591). Returns
    (episode return sum, episodes ended, {metric: sum at episode ends}) as
    tensors; a return is the sum over steps of the mean reward over agents.
    ``rnn`` is the policy's carried state: reset to 0 where an env ended."""
    vec = VecEnv(env, n_envs)
    env_state, ts = vec.reset(noise)
    obs, avail = ts.obs, ts.available_actions
    device = obs.device
    metric_keys = sorted(getattr(env, "metric_keys", None) or ())
    ep_ret = torch.zeros(n_envs, device=device)
    masks = torch.ones(n_envs, device=device)
    ret_sum, cnt = torch.zeros((), device=device), torch.zeros((), device=device)
    msums: Dict[str, torch.Tensor] = {k: torch.zeros((), device=device) for k in metric_keys}
    rnn = rnn0
    for _ in range(steps):
        stacked, rnn = act(obs, avail, masks, rnn)
        tr = vec.step(env_state, stacked, noise)
        done = tr.ts.dones.all(dim=1)
        done_f = done.to(torch.float32)
        ep_ret = ep_ret + tr.ts.rewards[:, :, 0].mean(dim=1)
        ret_sum = ret_sum + (ep_ret * done_f).sum()
        cnt = cnt + done_f.sum()
        for k in metric_keys:
            msums[k] = msums[k] + (tr.final.metrics[k] * done_f).sum()
        ep_ret = torch.where(done, 0.0, ep_ret)
        masks = 1.0 - done_f
        if rnn is not None:
            rnn = [torch.where(done[:, None, None], 0.0, h) for h in rnn]
        env_state, obs, avail = tr.state, tr.ts.obs, tr.ts.available_actions
    return ret_sum, cnt, msums


def evaluate_rounds(rollout: Callable[[int], tuple], n_eval: int,
                    eval_episodes: int) -> Tuple[float, Dict[str, float]]:
    """Call ``rollout(round)`` until ``eval_episodes`` episodes have ended
    (at most 4× the rounds that would take at one episode an env); returns
    (mean return, {metric: mean per episode}), nan and {} if none ended."""
    ret_sum, cnt, msums = 0.0, 0.0, {}
    for r in range(max((eval_episodes + n_eval - 1) // n_eval, 1) * 4):
        rs, c, ms = rollout(r)
        ret_sum += float(rs)
        cnt += float(c)
        for k, v in ms.items():
            msums[k] = msums.get(k, 0.0) + float(v)
        if cnt >= eval_episodes:
            break
    if cnt == 0:
        return float("nan"), {}
    return ret_sum / cnt, {k: v / cnt for k, v in msums.items()}


def eval_len(env, default: int) -> int:
    """The env's own episode horizon, decoupled from the training rollout."""
    limit = (getattr(env, "episode_limit", None) or getattr(env, "max_cycles", None)
             or getattr(env, "episode_length", None))
    return int(limit) if limit else default
