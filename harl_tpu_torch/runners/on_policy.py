"""On-policy HARL runner (counterpart of ``harl_tpu/runners/on_policy.py``).

One ``train_iteration`` is, in order:

  rollout  — ``episode_length`` steps of the batched env with every agent's
             ``StochasticPolicy`` and the ``VNet`` critic, under no_grad;
  returns  — GAE (or discounted returns) on de-normalized values, through
             the CUDA kernels of ``ops/gae_kernels.py`` on a CUDA device;
  update   — the HARL sequential update over agents, in fixed or random
             order, with the factor carried from agent to agent
             (on_policy_ha_runner.py:47-124);
  critic   — VCritic epochs with ValueNorm.

Ported paths: EP and FP centralized states, MLP or GRU networks (chunked
or naive recurrent updates), Box and Discrete actions with availability
masks, pure-tensor envs. Under FP the critic runs per (env, agent) row, the
rewards, masks and returns are per agent (T, B, N, 1), and the advantages
are normalised once across agents. share_param, the other algorithms and
host envs are on the roadmap.

Mask bookkeeping (on_policy_base_runner.py:342-460):
  masks[t+1]        = 0 where env done at step t (all agents done)
  active_masks[t+1] = 0 where agent died at t, reset to 1 on env done
  bad_masks[t+1]    = 0 where the step was a truncation (bad_transition)
  rnn states zeroed on env done.

Randomness comes from one ``torch.Generator`` per runner, seeded by
``init_state(seed)``, through a noise source (``utils/noise.py``); a caller
may pass its own noise source instead.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional

import torch

from harl_tpu_torch.algos.common import AgentTrainState, aggregate_ratio, make_optimizer
from harl_tpu_torch.algos.critics import CriticBatch, VCritic
from harl_tpu_torch.algos.happo import ActorBatch, HAPPOActor
from harl_tpu_torch.envs import make_env
from harl_tpu_torch.envs.core import VecEnv
from harl_tpu_torch.models.act import act_sample
from harl_tpu_torch.models.policies import StochasticPolicy
from harl_tpu_torch.models.values import VNet
from harl_tpu_torch.ops.returns import (compute_discounted_returns, compute_gae,
                                        normalize_advantages_masked)
from harl_tpu_torch.ops.value_norm import ValueNormState, denormalize, init_value_norm
from harl_tpu_torch.utils import spaces
from harl_tpu_torch.utils.device import DeviceLike, resolve_device
from harl_tpu_torch.utils.noise import GeneratorNoise

# per-agent step data: lists over agents, each stacked over time
PER_AGENT_KEYS = ("actions", "logp", "actor_rnn")


class RolloutCarry(NamedTuple):
    env_state: Any
    obs: torch.Tensor           # (B, N, max_obs_dim)
    share_obs: torch.Tensor     # EP (B, ds); FP (B, N, ds)
    masks: torch.Tensor         # (B, N, 1)
    active_masks: torch.Tensor  # (B, N, 1)
    avail: Optional[torch.Tensor]                # (B, N, n_actions) or None
    actor_rnn: Optional[List[torch.Tensor]]      # per agent (B, recurrent_n, H)
    critic_rnn: Optional[torch.Tensor]           # EP (B, recurrent_n, H); FP (B·N, …)
    ep_ret: torch.Tensor        # (B,) running episodic return


@dataclasses.dataclass
class TrainState:
    actors: List[AgentTrainState]
    critic: AgentTrainState
    value_norm: Optional[ValueNormState]
    carry: RolloutCarry


def _space_n(space) -> int:
    """Width of an agent's slice of the padded action / availability rows."""
    return space.n if spaces.space_kind(space) == "Discrete" else space.shape[0]


class OnPolicyRunner:
    """HAPPO runner. ``args``: {"algo", "env", …}; ``algo_args``: the YAML
    sections (train/model/algo); ``env_args``: env kwargs. ``device`` is
    CUDA unless given; ``noise`` replaces the generator-backed noise source."""

    def __init__(self, args: dict, algo_args: dict, env_args: dict,
                 device: DeviceLike = None, noise=None):
        self.device = resolve_device(device)
        if args.get("algo", "happo") != "happo":
            raise NotImplementedError(
                f"algo {args.get('algo')!r} is not ported yet (ROADMAP.md, HATRPO, "
                "HAA2C, MAPPO)")
        tr, al, md = algo_args["train"], algo_args["algo"], algo_args["model"]
        self.episode_length = tr["episode_length"]
        self.n_rollout_threads = tr["n_rollout_threads"]
        self.use_valuenorm = tr.get("use_valuenorm", True)
        self.use_proper_time_limits = tr.get("use_proper_time_limits", True)
        self.use_gae = al.get("use_gae", True)
        self.gamma = al.get("gamma", 0.99)
        self.gae_lambda = al.get("gae_lambda", 0.95)
        self.fixed_order = al.get("fixed_order", False)
        self.action_aggregation = al.get("action_aggregation", "prod")
        if al.get("share_param", False):
            raise NotImplementedError(
                "share_param is not ported yet (ROADMAP.md, options of the ported "
                "modules)")
        self.md = md
        self.hidden_sizes = tuple(md["hidden_sizes"])
        self.recurrent_n = md.get("recurrent_n", 1)
        self.use_rnn = (md.get("use_recurrent_policy", False)
                        or md.get("use_naive_recurrent_policy", False))
        self.max_grad_norm = (al.get("max_grad_norm", 10.0)
                              if al.get("use_max_grad_norm", True) else None)
        self.use_linear_lr_decay = tr.get("use_linear_lr_decay", False)

        env = make_env(args["env"], env_args, self.device)
        self.env = env
        self.vec = VecEnv(env, self.n_rollout_threads)
        self.n_agents = env.n_agents
        self.act_spaces = env.action_space
        self.obs_dims = [sp.shape[0] for sp in env.observation_space]
        self.share_obs_dim = env.share_observation_space[0].shape[0]
        self.state_type = getattr(env, "state_type", env_args.get("state_type", "EP"))
        if self.fp and getattr(env, "fp_state_dim", None) is None:
            raise NotImplementedError(
                f"{args['env']} has no FP state (ROADMAP.md, remaining pure-JAX envs)")

        algo_cfg = {**al, **md}
        self.actors = [HAPPOActor(self.act_spaces[i], algo_cfg) for i in range(self.n_agents)]
        self.critic = VCritic(algo_cfg)
        self.generator = torch.Generator(device=self.device)
        self.noise = noise if noise is not None else GeneratorNoise(self.generator, self.device)

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

    def _optimizer(self, net, lr: float):
        return make_optimizer(net.parameters(), lr, self.md.get("opti_eps", 1e-5),
                              self.md.get("weight_decay", 0.0), self.max_grad_norm,
                              self.use_linear_lr_decay)

    @property
    def fp(self) -> bool:
        return self.state_type == "FP"

    def init_state(self, seed: int) -> TrainState:
        """Seed the runner's generator, reset the envs, build fresh networks."""
        self.generator.manual_seed(seed)
        env_state, ts = self.vec.reset(self.noise)
        md = self.md
        actors = []
        for i in range(self.n_agents):
            policy = StochasticPolicy(
                self.obs_dims[i], self.act_spaces[i], gain=md.get("gain", 0.01),
                std_x_coef=md.get("std_x_coef", 1.0), **self._model_kwargs())
            actors.append(AgentTrainState(policy, self._optimizer(policy, md["lr"])))
        vnet = VNet(self.share_obs_dim, **self._model_kwargs())
        critic = AgentTrainState(vnet, self._optimizer(vnet, md["critic_lr"]))
        B, N, H = self.n_rollout_threads, self.n_agents, self.hidden_sizes[-1]
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
    def _policy_step(self, actors: List[AgentTrainState], carry: RolloutCarry):
        """All agents act once: (stacked padded actions, per-agent actions,
        per-agent log-probs, per-agent new hidden states or None)."""
        acts, logps, new_rnn = [], [], []
        for i, actor in enumerate(self.actors):
            space = self.act_spaces[i]
            obs_i = carry.obs[:, i, : self.obs_dims[i]]
            avail_i = None if carry.avail is None else carry.avail[:, i, : _space_n(space)]
            if self.use_rnn:
                head, h = actors[i].net(obs_i, carry.actor_rnn[i], carry.masks[:, i])
                new_rnn.append(h)
            else:
                head, _ = actors[i].net(obs_i)
            if spaces.space_kind(space) == "Discrete":
                noise = self.noise.gumbel_noise(head[0].shape)
            else:
                noise = self.noise.action_noise(head[0].shape)
            out = act_sample(noise, head, space, avail_i,
                             std_x_coef=actor.std_x_coef, std_y_coef=actor.std_y_coef)
            acts.append(out.actions)
            logps.append(out.log_probs)
        max_da = max(a.shape[-1] for a in acts)
        stacked = torch.stack(
            [torch.nn.functional.pad(a, (0, max_da - a.shape[-1])) for a in acts], dim=1)
        return stacked, acts, logps, new_rnn if self.use_rnn else None

    def _values(self, critic_net, share_obs, critic_rnn, masks):
        """V of the centralized state: EP (B, 1); FP (B, N, 1) from B·N rows.
        Returns (values, new critic hidden state or None)."""
        B, N = self.n_rollout_threads, self.n_agents
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
        B, N = self.n_rollout_threads, self.n_agents
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
        data = {k: torch.stack([s[k] for s in steps]) for k in steps[0]
                if k not in PER_AGENT_KEYS and k != "emitted_metrics"}
        for k in PER_AGENT_KEYS:
            if k in steps[0]:
                data[k] = [torch.stack([s[k][i] for s in steps]) for i in range(self.n_agents)]
        data["emitted_metrics"] = {k: torch.stack([s["emitted_metrics"][k] for s in steps])
                                   for k in steps[0]["emitted_metrics"]}
        return data

    # ------------------------------------------------------------- iteration
    def train_iteration(self, state: TrainState):
        """One rollout + update; updates ``state`` in place, returns
        (state, metrics) with the metrics as tensors on the device."""
        first_masks0 = state.carry.masks[:, 0]
        data = self.rollout(state)
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
            advantages = normalize_advantages_masked(advantages, data["active_masks"])
        avail = data.get("avail")
        batches = [
            ActorBatch(obs=data["obs"][:, :, i, : self.obs_dims[i]],
                       actions=data["actions"][i], logp=data["logp"][i],
                       active_masks=data["active_masks"][:, :, i],
                       rnn_states=data["actor_rnn"][i] if self.use_rnn else None,
                       masks=data["masks"][:, :, i],
                       available_actions=None if avail is None
                       else avail[:, :, i, : _space_n(self.act_spaces[i])])
            for i in range(N)
        ]
        actor_stats = self._sequential_update(state, batches, advantages, T, B)
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
        rows = self.critic.chunking.rows(T, critic_batch.share_obs.shape[1])
        state.value_norm, critic_stats = self.critic.update(
            state.critic, state.value_norm, critic_batch,
            self._perms(self.critic.critic_epoch, self.critic.num_mini_batch, rows))
        return dict(
            actor_stats=actor_stats,   # (N, [policy_loss, entropy, grad_norm, ratio])
            value_loss=critic_stats[0],
            critic_grad_norm=critic_stats[1],
            mean_step_reward=data["reward"].mean(),
            dead_ratio=1.0 - data["active_masks"].mean(),
            episode_return_sum=data["emitted_ret"].sum(),
            episode_count=data["emitted_cnt"].sum(),
            episode_metric_sums={k: v.sum() for k, v in data["emitted_metrics"].items()},
        )

    def _perms(self, epochs: int, num_mini_batch: int, M: int) -> Optional[torch.Tensor]:
        """Per-epoch shuffles for a multi-minibatch update, else None."""
        if num_mini_batch == 1:
            return None
        return torch.stack([self.noise.permutation(M) for _ in range(epochs)])

    def _sequential_update(self, state: TrainState, batches: List[ActorBatch],
                           advantages: torch.Tensor, T: int, B: int) -> torch.Tensor:
        """The HARL sequential update with the factor carried from agent to
        agent (on_policy_ha_runner.py:47-124)."""
        N = self.n_agents
        factor = torch.ones((T, B, 1), device=self.device)
        stats = torch.zeros((N, 4), device=self.device)
        if self.fixed_order or N == 1:
            order = list(range(N))
        else:
            order = self.noise.permutation(N).tolist()
        for i in order:
            actor, st, batch = self.actors[i], state.actors[i], batches[i]
            # pre-update params are the rollout params, so the stored
            # behavior log-probs are the old log-probs
            old_logp = batch.logp.reshape((-1,) + tuple(batch.logp.shape[2:]))
            stats[i] = actor.update(
                st, batch, advantages[:, :, i] if self.fp else advantages, factor,
                self._perms(actor.ppo_epoch, actor.num_mini_batch, actor.chunking.rows(T, B)),
                state_type=self.state_type)
            new_logp = actor.evaluate_logp(st.net, batch)
            factor = factor * aggregate_ratio(
                new_logp - old_logp, self.action_aggregation).reshape(T, B, 1)
        return stats
