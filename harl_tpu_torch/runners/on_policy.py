"""On-policy HARL runner (counterpart of ``harl_tpu/runners/on_policy.py``):
HAPPO, HATRPO, HAA2C and MAPPO (``algos.ON_POLICY_REGISTRY``).

One ``train_iteration`` is, in order:

  rollout  — ``episode_length`` steps of the batched env with every agent's
             ``StochasticPolicy`` and the ``VNet`` critic, under no_grad;
  returns  — GAE (or discounted returns) on de-normalized values, through
             the CUDA kernels of ``ops/gae_kernels.py`` on a CUDA device;
  update   — the HARL sequential update over agents, in fixed or random
             order, with the factor carried from agent to agent
             (on_policy_ha_runner.py:47-124) where the algorithm chains it
             (not MAPPO); MAPPO with ``share_param`` updates once on the
             agents' batches merged along the env axis (mappo.py:189-227);
  critic   — VCritic epochs with ValueNorm.

``run`` is the training loop around it: logging every ``log_interval``
iterations, evaluation and a checkpoint every ``eval_interval``, an optional
``torch.profiler`` trace of iterations 2–4 (``profile_trace_dir``), and a
resume from ``model_dir``. ``evaluate`` and ``render`` run the deterministic
policy on fresh envs.

Ported paths: EP and FP centralized states, MLP or GRU networks (chunked
or naive recurrent updates), vector or (H, W, C) pixel observations (the
actors on ``CNNBase``; the critic's state stays a vector), Box, Discrete
(with availability masks) and MultiDiscrete actions (``(…, k)`` integer
rows, one Gumbel draw a sub-head), ``share_param`` (one network and optimizer for every agent), linear
lr decay, pure-tensor envs, host envs (below) and data parallelism
(``run(mesh=…)``, below). Under FP the critic runs per (env, agent) row,
the rewards, masks and returns are per agent (T, B, N, 1), and the
advantages are normalised once across agents.

Host envs (``is_jax`` false: MAMuJoCo on MuJoCo, gym, the real games;
on_policy.py:121-135, 629-793): the envs step in NumPy on the host
(``envs/host.py``; a pre-vectorized env, the native MuJoCo engine, is used
whole), the policy and critic on the device. ``collect_host`` builds the
same data as ``rollout``, so ``update_phase`` (and its GAE kernel) is
shared. As in the JAX package, the host envs seed themselves (1, and 50000
for evaluation, whatever the run's seed), ``host_eval`` samples the
training policy with its hidden state and masks left at their initial
values, and the host render samples too (ROADMAP Queue C). FP states and
data parallelism over more than one rank refuse a host env.

Data parallelism (``parallel/mesh.py``): rank r of W steps the env columns
[r·B/W, (r+1)·B/W), drawing every env-axis random number at the global B
and keeping its rows, runs the GAE kernel on its (T, B/W) columns, and
trains on its rows of every global minibatch (``Share``); the gradients
are summed over the ranks, so the replicas take the same steps and the run
equals the one-rank run at the same B up to the order of float sums. The
iteration's metrics are global. Rank 0 alone evaluates, logs and writes
checkpoints, which hold the global carry.

Mask bookkeeping (on_policy_base_runner.py:342-460):
  masks[t+1]        = 0 where env done at step t (all agents done)
  active_masks[t+1] = 0 where agent died at t, reset to 1 on env done
  bad_masks[t+1]    = 0 where the step was a truncation (bad_transition)
  rnn states zeroed on env done.

Randomness comes from one ``torch.Generator`` per runner, seeded by
``init_state(seed)``, through a noise source (``utils/noise.py``); a caller
may pass its own noise source instead. Its draws, in order:

  init_state   the env reset (none for a host env), then (from the
               generator itself) the actors' and the critic's initial
               weights;
  rollout step per agent, ``action_noise`` (Box) or ``gumbel_noise``
               (Discrete) of its head's shape, or (MultiDiscrete)
               ``gumbel_noise`` once per sub-head in sub-head order, each of
               that sub-head's shape; then the env step's reset draws (none
               for a host env);
  update       the agent permutation (random order with N > 1, not MAPPO
               with ``share_param``); with several minibatches, each agent's
               per-epoch shuffles in update order (MAPPO with ``share_param``:
               one update's shuffles over the merged T·B·N rows, or chunks);
               then the critic's per-epoch shuffles.

Evaluation and rendering draw from generators of their own, seeded from the
run's seed and the round (``runners/common.py``), so a run with evaluation
trains exactly as a run without it; a host evaluation or render draws the
rollout step's action noise from its own, step after step.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from harl_tpu_torch.algos import ON_POLICY_REGISTRY
from harl_tpu_torch.algos.common import (AgentTrainState, Share, aggregate_ratio,
                                         make_optimizer)
from harl_tpu_torch.algos.critics import CriticBatch, VCritic
from harl_tpu_torch.algos.happo import ActorBatch
from harl_tpu_torch.algos.hatrpo import HATRPOActor
from harl_tpu_torch.envs import make_env
from harl_tpu_torch.envs.core import TimeStep, VecEnv
from harl_tpu_torch.envs.host import vectorize
from harl_tpu_torch.models.act import act_sample
from harl_tpu_torch.models.policies import StochasticPolicy
from harl_tpu_torch.models.values import VNet
from harl_tpu_torch.ops.returns import (compute_discounted_returns, compute_gae,
                                        normalize_advantages_masked)
from harl_tpu_torch.ops.value_norm import ValueNormState, denormalize, init_value_norm
from harl_tpu_torch.parallel.mesh import gather_tree, shard_tree
from harl_tpu_torch.runners import common
from harl_tpu_torch.utils import checkpoint, spaces
from harl_tpu_torch.utils.device import DeviceLike, resolve_device
from harl_tpu_torch.utils.noise import GeneratorNoise
from harl_tpu_torch.utils.profiling import start_trace, stop_trace

# per-agent step data: lists over agents, each stacked over time
PER_AGENT_KEYS = ("actions", "logp", "actor_rnn")


class RolloutCarry(NamedTuple):
    env_state: Any
    obs: torch.Tensor           # (B, N, max_obs_dim), or pixels (B, N, H, W, C)
    share_obs: torch.Tensor     # EP (B, ds); FP (B, N, ds)
    masks: torch.Tensor         # (B, N, 1)
    active_masks: torch.Tensor  # (B, N, 1)
    avail: Optional[torch.Tensor]                # (B, N, n_actions) or None
    actor_rnn: Optional[List[torch.Tensor]]      # per agent (B, recurrent_n, H)
    critic_rnn: Optional[torch.Tensor]           # EP (B, recurrent_n, H); FP (B·N, …)
    ep_ret: torch.Tensor        # (B,) running episodic return


@dataclasses.dataclass
class TrainState:
    actors: List[AgentTrainState]    # one per agent; a single one under share_param
    critic: AgentTrainState
    value_norm: Optional[ValueNormState]
    carry: RolloutCarry


def _space_n(space) -> int:
    """Width of an agent's slice of the padded availability rows
    (on_policy.py:1129-1135): n, Σ nvec, or a Box's dim."""
    kind = spaces.space_kind(space)
    if kind == "Discrete":
        return space.n
    if kind == "MultiDiscrete":
        return int(sum(space.nvec))
    return space.shape[0]


class OnPolicyRunner:
    """HAPPO, HATRPO, HAA2C and MAPPO runner. ``args``: {"algo", "env", …};
    ``algo_args``: the YAML sections (train/model/algo/eval); ``env_args``:
    env kwargs. ``device`` is CUDA unless given; ``noise`` replaces the
    generator-backed noise source; ``env`` replaces the env that ``args``
    and ``env_args`` name (a host env's further envs are still made from
    them)."""

    def __init__(self, args: dict, algo_args: dict, env_args: dict,
                 device: DeviceLike = None, noise=None, env=None):
        self.device = resolve_device(device)
        self.args, self.algo_args, self.env_args = args, algo_args, env_args
        algo = args.get("algo", "happo")
        if algo not in ON_POLICY_REGISTRY:
            raise ValueError(f"{algo!r} is not an on-policy algorithm "
                             f"({sorted(ON_POLICY_REGISTRY)})")
        actor_cls, self.factor_chain = ON_POLICY_REGISTRY[algo]
        tr, al, md = algo_args["train"], algo_args["algo"], algo_args["model"]
        self.episode_length = tr["episode_length"]
        self.n_rollout_threads = tr["n_rollout_threads"]
        self.num_env_steps = tr["num_env_steps"]
        self.episodes = max(int(self.num_env_steps) // self.episode_length
                            // self.n_rollout_threads, 1)
        self.use_valuenorm = tr.get("use_valuenorm", True)
        self.use_proper_time_limits = tr.get("use_proper_time_limits", True)
        self.use_gae = al.get("use_gae", True)
        self.gamma = al.get("gamma", 0.99)
        self.gae_lambda = al.get("gae_lambda", 0.95)
        self.fixed_order = al.get("fixed_order", False)
        self.action_aggregation = al.get("action_aggregation", "prod")
        self.share_param = al.get("share_param", False)
        self.md = md
        self.hidden_sizes = tuple(md["hidden_sizes"])
        self.recurrent_n = md.get("recurrent_n", 1)
        self.use_rnn = (md.get("use_recurrent_policy", False)
                        or md.get("use_naive_recurrent_policy", False))
        self.max_grad_norm = (al.get("max_grad_norm", 10.0)
                              if al.get("use_max_grad_norm", True) else None)
        self.use_linear_lr_decay = tr.get("use_linear_lr_decay", False)
        # optimizer steps an iteration, for the lr decay (on_policy.py:153-156)
        self.actor_updates = al.get(actor_cls.epoch_key, 1) * al.get("actor_num_mini_batch", 1)
        self.critic_updates = al["critic_epoch"] * al["critic_num_mini_batch"]

        env = make_env(args["env"], env_args, self.device) if env is None else env
        self.env = env
        self.host_mode = not getattr(env, "is_jax", True)
        if self.host_mode:
            self.host_vec = vectorize(env, args["env"], env_args, self.n_rollout_threads)
        self.n_agents = env.n_agents
        self.act_spaces = env.action_space
        # (H, W, C) observations go whole to a CNN torso (on_policy.py:142)
        self.image_obs = len(env.observation_space[0].shape) == 3
        self.obs_dims = [sp.shape[0] for sp in env.observation_space]
        self.obs_shapes = [tuple(sp.shape) for sp in env.observation_space]
        self.share_obs_dim = env.share_observation_space[0].shape[0]
        self.state_type = getattr(env, "state_type", env_args.get("state_type", "EP"))
        if self.fp and getattr(env, "fp_state_dim", None) is None:
            # the JAX runner fails on it too (on_policy.py:245)
            raise ValueError(f"state_type FP: {args['env']} has no FP state")

        algo_cfg = {**al, **md}
        if self.share_param:
            # homogeneity check (on_policy_base_runner.py:107-113)
            if not (all(d == self.obs_dims[0] for d in self.obs_dims)
                    and all(sp == self.act_spaces[0] for sp in self.act_spaces)):
                raise ValueError("share_param requires homogeneous agents")
            self.actors = [actor_cls(self.act_spaces[0], algo_cfg)] * self.n_agents
        else:
            self.actors = [actor_cls(self.act_spaces[i], algo_cfg) for i in range(self.n_agents)]
        self.critic = VCritic(algo_cfg)
        self.generator = torch.Generator(device=self.device)
        self.base_noise = (noise if noise is not None
                           else GeneratorNoise(self.generator, self.device))
        self.use_mesh(None)
        self.seed = 0

    def use_mesh(self, mesh) -> None:
        """Take the rank's env columns of a data-parallel ``mesh``, or all of
        them for None (``LOCAL``; ``runners/common.py``); ``run(mesh=…)``
        calls it."""
        common.attach_mesh(self, mesh)

    def _sidx(self, i: int) -> int:
        """Agent i's entry of ``TrainState.actors``."""
        return 0 if self.share_param else i

    def _obs_i(self, obs: torch.Tensor, i: int) -> torch.Tensor:
        """Agent i's obs from (…, N, ·): a vector sliced back from the padded
        width, or a whole (H, W, C) image (on_policy.py:211-216)."""
        if self.image_obs:
            return obs[..., i, :, :, :]
        return obs[..., i, : self.obs_dims[i]]

    # ------------------------------------------------------------------ init
    def _model_kwargs(self) -> dict:
        md = self.md
        return dict(
            hidden_sizes=self.hidden_sizes,
            activation_func=md.get("activation_func", "relu"),
            use_feature_normalization=md.get("use_feature_normalization", True),
            initialization_method=md.get("initialization_method", "orthogonal_"),
            use_recurrent_policy=self.use_rnn,
            recurrent_n=self.recurrent_n,
            device=self.device,
            generator=self.generator,
        )

    def _optimizer(self, net, lr: float, updates_per_iteration: int):
        return make_optimizer(net.parameters(), lr, self.md.get("opti_eps", 1e-5),
                              self.md.get("weight_decay", 0.0), self.max_grad_norm,
                              self.use_linear_lr_decay, self.episodes, updates_per_iteration,
                              self.mesh)

    @property
    def fp(self) -> bool:
        return self.state_type == "FP"

    def init_state(self, seed: int) -> TrainState:
        """Seed the runner's generator, reset the envs, build fresh networks
        (one policy for every agent under ``share_param``)."""
        self.seed = seed
        self.generator.manual_seed(seed)
        if self.host_mode:
            env_state, ts = None, common.host_timestep(*self.vec.reset(), self.device)
        else:
            env_state, ts = self.vec.reset(self.noise)
        md = self.md
        actors = []
        for i in range(1 if self.share_param else self.n_agents):
            policy = StochasticPolicy(
                self.obs_shapes[i] if self.image_obs else self.obs_dims[i], self.act_spaces[i], gain=md.get("gain", 0.01),
                std_x_coef=md.get("std_x_coef", 1.0), **self._model_kwargs())
            actors.append(AgentTrainState(policy, self._optimizer(policy, md["lr"],
                                                                  self.actor_updates)))
        vnet = VNet(self.share_obs_dim, **self._model_kwargs())
        critic = AgentTrainState(vnet, self._optimizer(vnet, md["critic_lr"],
                                                       self.critic_updates))
        B, N, H = self.n_envs, self.n_agents, self.hidden_sizes[-1]
        ones = torch.ones((B, N, 1), device=self.device)

        def zeros_rnn(rows):
            return torch.zeros((rows, self.recurrent_n, H), device=self.device)

        carry = RolloutCarry(
            env_state=env_state, obs=ts.obs,
            share_obs=ts.agent_state if self.fp else ts.share_obs,
            masks=ones, active_masks=ones.clone(), avail=ts.available_actions,
            actor_rnn=[zeros_rnn(B) for _ in range(N)] if self.use_rnn else None,
            # FP critics run per (env, agent): the GRU batch axis is B·N
            critic_rnn=zeros_rnn(B * N if self.fp else B) if self.use_rnn else None,
            ep_ret=torch.zeros(B, device=self.device))
        vn = init_value_norm(1, device=self.device) if self.use_valuenorm else None
        return TrainState(actors, critic, vn, carry)

    # --------------------------------------------------------------- rollout
    def _policy_step(self, actors: List[AgentTrainState], carry: RolloutCarry, noise=None):
        """All agents act once, drawing from ``noise`` (the runner's unless
        given): (stacked padded actions, per-agent actions, per-agent
        log-probs, per-agent new hidden states or None)."""
        noise = self.noise if noise is None else noise
        acts, logps, new_rnn = [], [], []
        for i, actor in enumerate(self.actors):
            space = self.act_spaces[i]
            obs_i = self._obs_i(carry.obs, i)
            avail_i = None if carry.avail is None else carry.avail[:, i, : _space_n(space)]
            net = actors[self._sidx(i)].net
            if self.use_rnn:
                head, h = net(obs_i, carry.actor_rnn[i], carry.masks[:, i])
                new_rnn.append(h)
            else:
                head, _ = net(obs_i)
            kind = spaces.space_kind(space)
            if kind == "MultiDiscrete":
                draw = [noise.gumbel_noise(h.shape) for h in head]
            elif kind == "Discrete":
                draw = noise.gumbel_noise(head[0].shape)
            else:
                draw = noise.action_noise(head[0].shape)
            out = act_sample(draw, head, space, avail_i,
                             std_x_coef=actor.std_x_coef, std_y_coef=actor.std_y_coef)
            acts.append(out.actions)
            logps.append(out.log_probs)
        return common.stack_actions(acts), acts, logps, new_rnn if self.use_rnn else None

    def _values(self, critic_net, share_obs, critic_rnn, masks):
        """V of the centralized state: EP (B, 1); FP (B, N, 1) from B·N rows.
        Returns (values, new critic hidden state or None)."""
        B, N = self.n_envs, self.n_agents
        if self.fp:
            share_obs = share_obs.reshape(B * N, -1)
        if self.use_rnn:
            masks = masks.reshape(B * N, 1) if self.fp else masks[:, 0]
            value, new_rnn = critic_net(share_obs, critic_rnn, masks)
        else:
            value, new_rnn = critic_net(share_obs)
        return (value.reshape(B, N, 1) if self.fp else value), new_rnn

    def rollout_step(self, state: TrainState, carry: RolloutCarry):
        actions, acts, logps, new_actor_rnn = self._policy_step(state.actors, carry)
        value, new_critic_rnn = self._values(state.critic.net, carry.share_obs,
                                             carry.critic_rnn, carry.masks)
        tr = self.vec.step(carry.env_state, actions, self.noise)
        ts = tr.ts
        B, N = self.n_envs, self.n_agents
        done_env = ts.dones.all(dim=1)                                 # (B,)
        d3 = done_env[:, None, None]
        ones = torch.ones((B, N, 1), device=self.device)
        new_masks = torch.where(d3, 0.0, ones)
        new_active = torch.where(ts.dones[..., None], 0.0, ones)
        new_active = torch.where(d3, 1.0, new_active)
        bad_mask = torch.where(ts.bad_transition, 0.0, 1.0)[:, None]   # (B, 1)
        # episodic return: per-agent mean reward, as the JAX runner counts it
        ep_ret = carry.ep_ret + ts.rewards[:, :, 0].mean(dim=1)
        if self.use_rnn:
            done_rows = done_env.repeat_interleave(N) if self.fp else done_env
            actor_rnn = [torch.where(d3, 0.0, h) for h in new_actor_rnn]
            critic_rnn = torch.where(done_rows[:, None, None], 0.0, new_critic_rnn)
        else:
            actor_rnn = critic_rnn = None
        new_carry = RolloutCarry(
            env_state=tr.state, obs=ts.obs,
            share_obs=ts.agent_state if self.fp else ts.share_obs,
            masks=new_masks, active_masks=new_active, avail=ts.available_actions,
            actor_rnn=actor_rnn, critic_rnn=critic_rnn,
            ep_ret=torch.where(done_env, 0.0, ep_ret))
        step_data = dict(
            obs=carry.obs, share_obs=carry.share_obs, masks=carry.masks,
            active_masks=carry.active_masks, actions=acts, logp=logps, value=value,
            # EP: agent-0 (team) reward and masks (B, 1); FP: per agent (B, N, 1)
            reward=ts.rewards if self.fp else ts.rewards[:, 0],
            next_masks=new_masks if self.fp else new_masks[:, 0],
            next_bad_masks=bad_mask[:, None].expand(B, N, 1) if self.fp else bad_mask,
            next_active=new_active,
            emitted_ret=torch.where(done_env, ep_ret, 0.0),
            emitted_cnt=done_env.to(torch.float32),
            # env-specific episode metrics (won, dead ratios) at episode ends
            emitted_metrics={k: torch.where(done_env, v, 0.0)
                             for k, v in (tr.final.metrics or {}).items()})
        if carry.avail is not None:
            step_data["avail"] = carry.avail
        if self.use_rnn:
            # hidden states at the INPUT of step t
            step_data["actor_rnn"] = carry.actor_rnn
            step_data["critic_rnn"] = carry.critic_rnn
        return new_carry, step_data

    @torch.no_grad()
    def rollout(self, state: TrainState) -> Dict[str, Any]:
        """``episode_length`` steps from ``state.carry``; advances the carry
        and returns the time-major data (per-agent lists for actions, logp
        and actor_rnn; a dict for the emitted metrics)."""
        carry, steps = state.carry, []
        for _ in range(self.episode_length):
            carry, step = self.rollout_step(state, carry)
            steps.append(step)
        state.carry = carry
        return self._stack_steps(steps)

    def _stack_steps(self, steps: List[dict]) -> Dict[str, Any]:
        """Per-step data → time-major tensors (per-agent lists for actions,
        logp and actor_rnn; a dict for the emitted metrics)."""
        data = {k: torch.stack([s[k] for s in steps]) for k in steps[0]
                if k not in PER_AGENT_KEYS and k != "emitted_metrics"}
        for k in PER_AGENT_KEYS:
            if k in steps[0]:
                data[k] = [torch.stack([s[k][i] for s in steps]) for i in range(self.n_agents)]
        data["emitted_metrics"] = {k: torch.stack([s["emitted_metrics"][k] for s in steps])
                                   for k in steps[0]["emitted_metrics"]}
        return data

    @torch.no_grad()
    def collect_host(self, state: TrainState) -> Dict[str, Any]:
        """``episode_length`` steps of the host envs (on_policy.py:641-723):
        each step the policies and the critic on the device, the actions
        copied to the host, the envs stepped there and their arrays copied
        back. Advances ``state.carry`` and returns the data of ``rollout``.
        As in the JAX package: the team reward is agent 0's, a step is a
        truncation where any agent's info says so, and the episode return
        adds the float32 mean reward over agents on the host."""
        B, N, dev = self.n_envs, self.n_agents, self.device
        carry, steps = state.carry, []
        ep_ret = carry.ep_ret.cpu().numpy()
        for _ in range(self.episode_length):
            actions, acts, logps, new_actor_rnn = self._policy_step(state.actors, carry)
            value, new_critic_rnn = self._values(state.critic.net, carry.share_obs,
                                                 carry.critic_rnn, carry.masks)
            res = self.vec.step(actions.cpu().numpy())
            dones = res["dones"]                                       # (B, N) bool
            done_env = dones.all(axis=1)
            bad = np.array([0.0 if any(a.get("bad_transition", False) for a in info) else 1.0
                            for info in res["infos"]], np.float32)[:, None]
            new_masks = np.ones((B, N, 1), np.float32)
            new_masks[done_env] = 0.0
            new_active = np.where(dones[..., None], 0.0, 1.0).astype(np.float32)
            new_active[done_env] = 1.0
            ep_ret = ep_ret + res["rewards"][:, :, 0].mean(axis=1)
            step = dict(obs=carry.obs, share_obs=carry.share_obs, masks=carry.masks,
                        active_masks=carry.active_masks, actions=acts, logp=logps, value=value,
                        emitted_metrics={})
            for k, v in (("reward", res["rewards"][:, 0]), ("next_masks", new_masks[:, 0]),
                         ("next_bad_masks", bad), ("next_active", new_active),
                         ("emitted_ret", np.where(done_env, ep_ret, 0.0)),
                         ("emitted_cnt", done_env)):
                step[k] = common.host_tensor(v, dev)
            if carry.avail is not None:
                step["avail"] = carry.avail
            masks = common.host_tensor(new_masks, dev)
            if self.use_rnn:
                # hidden states at the INPUT of step t, zeroed where an env ended
                step["actor_rnn"], step["critic_rnn"] = carry.actor_rnn, carry.critic_rnn
                d3 = masks[:, :1] == 0
                actor_rnn = [torch.where(d3, 0.0, h) for h in new_actor_rnn]
                critic_rnn = torch.where(d3, 0.0, new_critic_rnn)
            else:
                actor_rnn = critic_rnn = None
            steps.append(step)
            ep_ret = np.where(done_env, 0.0, ep_ret).astype(np.float32)
            ts = common.host_timestep(res["obs"], res["share_obs"], res["available_actions"],
                                      dev)
            carry = RolloutCarry(
                env_state=None, obs=ts.obs, share_obs=ts.share_obs, masks=masks,
                active_masks=step["next_active"], avail=ts.available_actions,
                actor_rnn=actor_rnn, critic_rnn=critic_rnn,
                ep_ret=common.host_tensor(ep_ret, dev))
        state.carry = carry
        return self._stack_steps(steps)

    # ------------------------------------------------------------- iteration
    def train_iteration(self, state: TrainState):
        """One rollout + update; updates ``state`` in place, returns
        (state, metrics) with the metrics as tensors on the device."""
        first_masks0 = state.carry.masks[:, 0]
        data = self.collect_host(state) if self.host_mode else self.rollout(state)
        c = state.carry
        metrics = self.update_phase(state, data, first_masks0, c.share_obs, c.masks, c.critic_rnn)
        return state, metrics

    @torch.no_grad()
    def returns_inputs(self, state: TrainState, data, first_masks0, last_share_obs,
                       last_masks=None, last_critic_rnn=None):
        """The recursion's inputs: (rewards (T, …), de-normalized values,
        masks and bad masks (T+1, …) or None); EP (…) = (B, 1), FP (B, N, 1)."""
        next_value, _ = self._values(state.critic.net, last_share_obs, last_critic_rnn,
                                     last_masks)
        values = torch.cat([data["value"], next_value[None]], dim=0)
        values_den = (denormalize(state.value_norm, values)
                      if state.value_norm is not None else values)
        first = data["masks"][0] if self.fp else first_masks0
        masks_tb = torch.cat([first[None], data["next_masks"]], dim=0)
        bad_tb = torch.cat([torch.ones_like(first)[None], data["next_bad_masks"]], dim=0)
        return data["reward"], values_den, masks_tb, (
            bad_tb if self.use_proper_time_limits else None)

    @torch.no_grad()
    def compute_returns(self, state: TrainState, data, first_masks0, last_share_obs,
                        last_masks=None, last_critic_rnn=None):
        """(returns, de-normalized values (T+1, …)) for the rollout."""
        rewards, values_den, masks_tb, bad = self.returns_inputs(
            state, data, first_masks0, last_share_obs, last_masks, last_critic_rnn)
        if self.use_gae:
            returns = compute_gae(rewards, values_den, masks_tb, bad, self.gamma,
                                  self.gae_lambda)
        else:
            returns = compute_discounted_returns(rewards, values_den, masks_tb, bad,
                                                 values_den[-1], self.gamma)
        return returns, values_den

    def _share(self, per_env: int = 1, agents: int = 1) -> Share:
        """This rank's columns of a batch of ``agents`` env-axis blocks
        side by side, each with ``per_env`` consecutive columns an env (FP
        critic rows)."""
        B = self.n_rollout_threads
        cols = (self.env_cols[:, None] * per_env + torch.arange(per_env)).reshape(-1)
        return Share(self.mesh, torch.cat([cols + i * B * per_env for i in range(agents)]),
                     B * per_env * agents)

    def update_phase(self, state: TrainState, data, first_masks0, last_share_obs,
                     last_masks=None, last_critic_rnn=None):
        """Returns + sequential actor update + critic train (in place)."""
        T, B, N = data["reward"].shape[0], data["reward"].shape[1], self.n_agents
        returns, values_den = self.compute_returns(state, data, first_masks0, last_share_obs,
                                                   last_masks, last_critic_rnn)
        advantages = returns - values_den[:-1]               # EP (T, B, 1); FP (T, B, N, 1)
        if self.fp:
            # normalised once across agents with the active masks
            # (on_policy_ha_runner.py:36-45)
            advantages = normalize_advantages_masked(advantages, data["active_masks"],
                                                     self.mesh)
        avail = data.get("avail")
        batches = [
            ActorBatch(obs=self._obs_i(data["obs"], i),
                       actions=data["actions"][i], logp=data["logp"][i],
                       active_masks=data["active_masks"][:, :, i],
                       rnn_states=data["actor_rnn"][i] if self.use_rnn else None,
                       masks=data["masks"][:, :, i],
                       available_actions=None if avail is None
                       else avail[:, :, i, : _space_n(self.act_spaces[i])])
            for i in range(N)
        ]
        if self.share_param and not self.factor_chain:
            actor_stats = self._merged_update(state, batches, advantages, T, B)
        else:
            actor_stats, fractions = self._sequential_update(state, batches, advantages, T, B)
        if self.fp:
            critic_batch = CriticBatch(
                share_obs=data["share_obs"].reshape(T, B * N, -1),
                value_preds=data["value"].reshape(T, B * N, 1),
                returns=returns.reshape(T, B * N, 1),
                rnn_states=data.get("critic_rnn"),
                masks=data["masks"].reshape(T, B * N, 1))
        else:
            critic_batch = CriticBatch(
                share_obs=data["share_obs"], value_preds=data["value"], returns=returns,
                rnn_states=data.get("critic_rnn"), masks=data["masks"][:, :, 0])
        critic_share = self._share(N if self.fp else 1)
        rows = self.critic.chunking.rows(T, self.n_rollout_threads * (N if self.fp else 1))
        state.value_norm, critic_stats = self.critic.update(
            state.critic, state.value_norm, critic_batch,
            self._perms(self.critic.critic_epoch, self.critic.num_mini_batch, rows),
            share=critic_share)
        metric_keys = sorted(data["emitted_metrics"])
        sums = [data["reward"].sum(), data["active_masks"].sum(), data["emitted_ret"].sum(),
                data["emitted_cnt"].sum()] + [data["emitted_metrics"][k].sum()
                                              for k in metric_keys]
        # every rank holds as many rows: the global means are the sums over
        # W times the local counts
        sums = self.mesh.all_reduce_sum(sums)
        mean_step_reward = sums[0] / (data["reward"].numel() * self.mesh.world)
        active_mean = sums[1] / (data["active_masks"].numel() * self.mesh.world)
        metrics = dict(
            actor_stats=actor_stats,   # (N, [policy_loss, entropy, grad_norm, ratio])
            value_loss=critic_stats[0],
            critic_grad_norm=critic_stats[1],
            mean_step_reward=mean_step_reward,
            dead_ratio=1.0 - active_mean,
            episode_return_sum=sums[2],
            episode_count=sums[3],
            episode_metric_sums=dict(zip(metric_keys, sums[4:])),
        )
        if isinstance(self.actors[0], HATRPOActor):
            # HATRPO's stats are [improvement, entropy, kl, ratio]; the
            # accepted line-search fractions, per agent, were read on the host
            metrics["ls_fraction"] = fractions
        return metrics

    def _perms(self, epochs: int, num_mini_batch: int, M: int) -> Optional[torch.Tensor]:
        """Per-epoch shuffles for a multi-minibatch update, else None."""
        if num_mini_batch == 1:
            return None
        return torch.stack([self.noise.permutation(M) for _ in range(epochs)])

    def _sequential_update(self, state: TrainState, batches: List[ActorBatch],
                           advantages: torch.Tensor, T: int, B: int):
        """The HARL sequential update, with the factor carried from agent to
        agent where the algorithm chains it (on_policy_ha_runner.py:47-124).
        Returns (stats (N, 4), per-agent accepted line-search fractions:
        HATRPO's, else zeros)."""
        N = self.n_agents
        factor = torch.ones((T, B, 1), device=self.device)
        stats = torch.zeros((N, 4), device=self.device)
        fractions = [0.0] * N
        if self.fixed_order or N == 1:
            order = list(range(N))
        else:
            order = self.noise.permutation(N).tolist()
        for i in order:
            actor, st, batch = self.actors[i], state.actors[self._sidx(i)], batches[i]
            if self.factor_chain:
                if self.share_param:
                    # earlier agents of the order moved the shared parameters
                    # already (on_policy_ha_runner.py:66-83)
                    old_logp = actor.evaluate_logp(st.net, batch)
                else:
                    # pre-update params are the rollout params, so the stored
                    # behavior log-probs are the old log-probs
                    old_logp = batch.logp.reshape((-1,) + tuple(batch.logp.shape[2:]))
            stats[i] = actor.update(
                st, batch, advantages[:, :, i] if self.fp else advantages, factor,
                self._perms(actor.ppo_epoch, actor.num_mini_batch,
                            actor.chunking.rows(T, self.n_rollout_threads)),
                state_type=self.state_type, share=self._share())
            fractions[i] = getattr(actor, "last_fraction", 0.0)
            if self.factor_chain:
                new_logp = actor.evaluate_logp(st.net, batch)
                factor = factor * aggregate_ratio(
                    new_logp - old_logp, self.action_aggregation).reshape(T, B, 1)
        return stats, fractions

    def _merged_update(self, state: TrainState, batches: List[ActorBatch],
                       advantages: torch.Tensor, T: int, B: int):
        """MAPPO with ``share_param``: one update on the agents' batches
        concatenated along the env axis, all-ones factor (mappo.py:189-227).
        Under EP every agent sees the team advantages, under FP its own."""
        N, actor = self.n_agents, self.actors[0]

        def cat(name):
            parts = [getattr(b, name) for b in batches]
            return None if parts[0] is None else torch.cat(parts, dim=1)

        merged = ActorBatch(**{name: cat(name) for name in ActorBatch._fields})
        adv = (torch.cat([advantages[:, :, i] for i in range(N)], dim=1) if self.fp
               else advantages.repeat(1, N, 1))
        stats = actor.update(
            state.actors[0], merged, adv, torch.ones((T, B * N, 1), device=self.device),
            self._perms(actor.ppo_epoch, actor.num_mini_batch,
                        actor.chunking.rows(T, self.n_rollout_threads * N)),
            state_type=self.state_type, share=self._share(agents=N))
        return stats[None].expand(N, 4)

    # ------------------------------------------------------------------ eval
    def _deterministic_actions(self, state: TrainState, obs, avail, masks, rnn):
        """Every agent's mode action (stacked) and new hidden states."""
        acts, new_rnn = [], []
        for i, actor in enumerate(self.actors):
            net = state.actors[self._sidx(i)].net
            obs_i = self._obs_i(obs, i)
            avail_i = None if avail is None else avail[:, i, : _space_n(self.act_spaces[i])]
            if rnn is not None:
                head, h = net(obs_i, rnn[i], masks[:, None])
                new_rnn.append(h)
            else:
                head, _ = net(obs_i)
            acts.append(act_sample(None, head, self.act_spaces[i], avail_i, deterministic=True,
                                   std_x_coef=actor.std_x_coef,
                                   std_y_coef=actor.std_y_coef).actions)
        return common.stack_actions(acts), (new_rnn if rnn is not None else None)

    def eval_noise(self, round_idx: int):
        """The noise source of evaluation round ``round_idx``."""
        return common.derived_noise(self.seed, common.ON_POLICY_EVAL_SALT, round_idx, self.device)

    def eval_rollout(self, state: TrainState, n_eval_envs: int, round_idx: int = 0):
        """The deterministic policy over one env horizon of ``n_eval_envs``
        auto-reset envs (on_policy.py:792-866); returns the sums (episode
        return, episodes ended, {metric: sum}) as tensors."""
        H = self.hidden_sizes[-1]
        rnn0 = ([torch.zeros((n_eval_envs, self.recurrent_n, H), device=self.device)
                 for _ in range(self.n_agents)] if self.use_rnn else None)
        return common.eval_rollout(
            self.env, n_eval_envs, self._eval_len(), self.eval_noise(round_idx),
            lambda obs, avail, masks, rnn: self._deterministic_actions(state, obs, avail,
                                                                        masks, rnn), rnn0)

    def evaluate(self, state: TrainState, n_eval: int, eval_episodes: int):
        """Rounds of ``eval_rollout`` until ``eval_episodes`` episodes ended
        (on_policy_base_runner.py:587-591); returns (mean return, metrics)."""
        return common.evaluate_rounds(lambda r: self.eval_rollout(state, n_eval, r),
                                      n_eval, eval_episodes)

    def _eval_len(self) -> int:
        return common.eval_len(self.env, self.episode_length)

    def _host_carry(self, ts: TimeStep) -> RolloutCarry:
        """A fresh carry for an evaluation or render batch of host envs."""
        B, N, H = ts.obs.shape[0], self.n_agents, self.hidden_sizes[-1]
        rnn = [torch.zeros((B, self.recurrent_n, H), device=self.device)
               for _ in range(N)] if self.use_rnn else None
        ones = torch.ones((B, N, 1), device=self.device)
        return RolloutCarry(env_state=None, obs=ts.obs, share_obs=ts.share_obs, masks=ones,
                            active_masks=ones, avail=ts.available_actions, actor_rnn=rnn,
                            critic_rnn=None, ep_ret=torch.zeros(B, device=self.device))

    @torch.no_grad()
    def host_eval(self, state: TrainState, n_episodes: int = 10, noise=None) -> float:
        """The mean return of the first episode of each of ``min(n_episodes,
        10)`` fresh host envs seeded from 50000 (an env still running at the
        horizon counts its partial return), as ``host_eval`` of the JAX
        package (on_policy.py:738-793) computes it: the training policy
        samples its actions (from ``noise``, else a generator of its own),
        and the hidden states and masks keep their initial values."""
        noise = noise if noise is not None else common.derived_noise(
            self.seed, common.HOST_EVAL_SALT, 0, self.device)
        n_envs = min(n_episodes, 10)
        vec = vectorize(make_env(self.args["env"], self.env_args), self.args["env"],
                        self.env_args, n_envs, seed=50000)
        carry = self._host_carry(common.host_timestep(*vec.reset(), self.device))
        ep_ret = np.zeros(n_envs)                    # float64, as in the JAX package
        alive = np.ones(n_envs, bool)
        returns: List[float] = []
        for _ in range(getattr(self.env, "episode_limit", 1000)):
            stacked, *_ = self._policy_step(state.actors, carry, noise)
            res = vec.step(stacked.cpu().numpy())
            done_env = res["dones"].all(axis=1)
            ep_ret += res["rewards"][:, :, 0].mean(axis=1) * alive
            returns.extend(ep_ret[done_env & alive].tolist())
            alive &= ~done_env
            if not alive.any():
                break
            ts = common.host_timestep(res["obs"], res["share_obs"], res["available_actions"],
                                      self.device)
            carry = carry._replace(obs=ts.obs, share_obs=ts.share_obs, avail=ts.available_actions)
        vec.close()
        returns.extend(ep_ret[alive].tolist())
        return float(np.mean(returns))

    @torch.no_grad()
    def render(self, state: TrainState, episodes: int = 10, save_path: Optional[str] = None):
        """Deterministic rollouts of ``episodes`` envs over one env horizon,
        saved as ``.npz`` trajectories (obs, actions, rewards) for offline
        viewing (on_policy.py:947-992); returns each env's reward sum. As in
        the JAX package, a recurrent policy acts from zero hidden states.
        A host env renders through its own ``render()`` instead
        (``_render_host``)."""
        noise = common.derived_noise(self.seed, common.RENDER_SALT, 0, self.device)
        if self.host_mode:
            return self._render_host(state, episodes, noise)
        vec = VecEnv(self.env, episodes)
        env_state, ts = vec.reset(noise)
        obs, avail = ts.obs, ts.available_actions
        obs_traj, act_traj, rew_traj = [], [], []
        for _ in range(self._eval_len()):
            stacked, _ = self._deterministic_actions(state, obs, avail, None, None)
            tr = vec.step(env_state, stacked, noise)
            env_state, obs, avail = tr.state, tr.ts.obs, tr.ts.available_actions
            obs_traj.append(obs)
            act_traj.append(stacked)
            rew_traj.append(tr.ts.rewards[:, :, 0].mean(dim=1))
        rewards = torch.stack(rew_traj).cpu().numpy()
        if save_path:
            np.savez(save_path, obs=torch.stack(obs_traj).cpu().numpy(),
                     actions=torch.stack(act_traj).cpu().numpy(), rewards=rewards)
            print(f"saved render trajectories to {save_path}")
        return [float(r) for r in rewards.sum(axis=0)]

    def _render_host(self, state: TrainState, episodes: int, noise) -> List[float]:
        """``episodes`` episodes of one fresh host env, each up to the env's
        ``episode_limit`` (1000 without one), calling its ``render()`` after
        every step (on_policy.py:904-946): the training policy samples its
        actions from ``noise``, from the initial hidden states and masks.
        Returns each episode's agent-0 reward sum. A pre-vectorized env runs
        as a batch of one."""
        env = make_env(self.args["env"], self.env_args)
        batched = getattr(env, "is_vectorized", False)
        if batched:
            env.ensure_envs(1)
        returns = []
        for ep in range(episodes):
            obs, share, avail = env.reset()
            if not batched:
                obs, share, avail = (None if x is None else np.asarray(x)[None]
                                     for x in (obs, share, avail))
            carry = self._host_carry(common.host_timestep(obs, share, avail, self.device))
            total = 0.0
            for _ in range(getattr(self.env, "episode_limit", 1000)):
                stacked = self._policy_step(state.actors, carry, noise)[0].cpu().numpy()
                if batched:
                    res = env.step(stacked)
                    o, sh, r, d, av = (res["obs"], res["share_obs"], res["rewards"][0],
                                       res["dones"][0], res["available_actions"])
                else:
                    o, sh, r, d, _, av = env.step(stacked[0])
                    o, sh, av = (None if x is None else np.asarray(x)[None] for x in (o, sh, av))
                if hasattr(env, "render"):
                    try:
                        env.render()
                    except Exception:        # an env without a viewer here
                        pass
                total += float(r[0, 0])
                if np.all(d):
                    break
                ts = common.host_timestep(o, sh, av, self.device)
                carry = carry._replace(obs=ts.obs, share_obs=ts.share_obs,
                                       avail=ts.available_actions)
            returns.append(total)
            print(f"render episode {ep}: return {total:.2f}")
        env.close()
        return returns

    # ----------------------------------------------------------- checkpoint
    def checkpoint(self, state: TrainState) -> dict:
        """The full train state as a plain payload (``utils/checkpoint.py``):
        networks, optimizers, ValueNorm, the rollout carry with the env
        state's tensors, and the generator's state. The carry is every
        rank's env columns: the payload is the one-rank run's."""
        state = dataclasses.replace(state, carry=gather_tree(self.mesh, state.carry))
        return {"state": checkpoint.to_payload(state),
                "generator": self.generator.get_state(), "seed": self.seed}

    def load_checkpoint(self, state: TrainState, payload: dict) -> TrainState:
        """Load a payload of ``checkpoint`` into ``state``; raises
        ``ValueError`` (and changes nothing) where its structure differs.
        Each rank takes its env columns of the global carry."""
        payload = {**payload, "state": {**payload["state"], "carry": shard_tree(
            self.mesh, payload["state"]["carry"])}}
        state = checkpoint.load_payload(state, payload["state"])
        self.generator.set_state(payload["generator"].cpu())
        self.seed = int(payload["seed"])
        return state

    def restore(self, state: TrainState, model_dir: str) -> TrainState:
        """Resume from the latest checkpoint under ``model_dir``: the full
        state, or, where its structure differs from the live run's (another
        env batch, another optimizer), the networks and ValueNorm only
        (on_policy.py:994-1019)."""
        path = checkpoint.latest_checkpoint(model_dir) or model_dir
        print(f"restoring train state from {path}")
        try:
            return self.load_checkpoint(state, checkpoint.restore_state(path))
        except ValueError as e:
            print(f"full-state resume structure mismatch ({e}); falling back to a "
                  "params-only restore (networks and ValueNorm, fresh optimizers)")
            return checkpoint.restore_params_into(path, state)

    # ------------------------------------------------------------------- run
    def run(self, seed: int = 1, log_fn=None, logger=None, save_dir: Optional[str] = None,
            mesh=None):
        """The training loop (on_policy_base_runner.py:171-267): ``episodes``
        iterations; a log record every ``log_interval`` iterations and at the
        last; every ``eval_interval`` and at the last, an evaluation (with
        ``use_eval``) and a checkpoint (whether or not eval is on). Returns
        (state, the log records). With a ``mesh`` (``parallel/mesh.py``)
        this process trains its rank's env columns; rank 0 alone
        evaluates, logs, traces and writes, and every rank must get a
        ``save_dir`` where rank 0 does (the checkpoint gathers the carry)."""
        self.use_mesh(mesh)
        main = self.mesh.is_main
        state = self.init_state(seed)
        tr, ev = self.algo_args["train"], self.algo_args.get("eval", {}) or {}
        if tr.get("model_dir"):
            state = self.restore(state, tr["model_dir"])
        steps_per_iter = self.episode_length * self.n_rollout_threads
        log_interval = tr.get("log_interval", 5)
        eval_interval = tr.get("eval_interval", 25)
        use_eval = ev.get("use_eval", False) and main
        n_eval = ev.get("n_eval_rollout_threads", 10)
        profile_dir, trace = tr.get("profile_trace_dir") if main else None, None
        history: List[dict] = []
        t_start = time.time()
        last_return = math.nan
        try:
            for episode in range(1, self.episodes + 1):
                if profile_dir and episode == 2:
                    trace = start_trace(profile_dir, self.device)
                state, metrics = self.train_iteration(state)
                if trace is not None and episode == 4:
                    _sync(self.device)
                    stop_trace(trace)
                    trace = None
                if episode % log_interval == 0 or episode == self.episodes:
                    count = float(metrics["episode_count"])
                    if count > 0:   # keep the last value when no episode ended
                        last_return = float(metrics["episode_return_sum"]) / count
                    astats = metrics["actor_stats"].tolist()
                    rec = dict(
                        episode=episode, steps=episode * steps_per_iter,
                        mean_episode_return=last_return,
                        # the iteration's mean reward an agent and step
                        mean_step_reward=float(metrics["mean_step_reward"]),
                        value_loss=float(metrics["value_loss"]),
                        critic_grad_norm=float(metrics["critic_grad_norm"]),
                        dead_ratio=float(metrics["dead_ratio"]),
                        fps=episode * steps_per_iter / (time.time() - t_start),
                        agent_stats=[dict(policy_loss=a[0], dist_entropy=a[1],
                                          actor_grad_norm=a[2], ratio=a[3]) for a in astats])
                    if count > 0:
                        # the env-logger family (SMAC win rate, …)
                        for k, v in metrics["episode_metric_sums"].items():
                            rec["win_rate" if k == "won" else k] = float(v) / count
                    history.append(rec)
                    if logger is not None and main:
                        logger.log_episode(rec)
                    if log_fn and main:
                        log_fn(rec)
                if episode % eval_interval == 0 or episode == self.episodes:
                    if use_eval:
                        # a host env: the JAX package's host evaluation
                        # (on_policy.py:776-779)
                        eval_ret, extra = ((self.host_eval(state, n_eval), {}) if self.host_mode
                                           else self.evaluate(state, n_eval,
                                                              ev.get("eval_episodes", n_eval)))
                        if logger is not None and main:
                            logger.log_eval(episode * steps_per_iter, eval_ret, extra)
                        if history:
                            history[-1]["eval_return"] = eval_ret
                            for k, v in extra.items():
                                history[-1]["eval_win_rate" if k == "won" else f"eval_{k}"] = v
                    # saved every eval_interval whether or not eval is on
                    # (on_policy_base_runner.py:260-265)
                    if save_dir is not None:
                        payload = self.checkpoint(state)
                        if main:
                            checkpoint.save_state(save_dir, payload, episode * steps_per_iter)
        finally:
            if trace is not None:
                stop_trace(trace)
        return state, history


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
