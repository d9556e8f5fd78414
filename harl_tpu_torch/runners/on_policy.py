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

Ported path: EP state, MLP networks, Box actions, pure-tensor env. The
recurrent, FP, discrete, share_param and host-env paths are on the roadmap.

Mask bookkeeping (on_policy_base_runner.py:342-460):
  masks[t+1]        = 0 where env done at step t (all agents done)
  active_masks[t+1] = 0 where agent died at t, reset to 1 on env done
  bad_masks[t+1]    = 0 where the step was a truncation (bad_transition)

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
from harl_tpu_torch.ops.returns import compute_discounted_returns, compute_gae
from harl_tpu_torch.ops.value_norm import ValueNormState, denormalize, init_value_norm
from harl_tpu_torch.utils.device import DeviceLike, resolve_device
from harl_tpu_torch.utils.noise import GeneratorNoise


class RolloutCarry(NamedTuple):
    env_state: Any
    obs: torch.Tensor           # (B, N, max_obs_dim)
    share_obs: torch.Tensor     # (B, ds)
    masks: torch.Tensor         # (B, N, 1)
    active_masks: torch.Tensor  # (B, N, 1)
    ep_ret: torch.Tensor        # (B,) running episodic return


@dataclasses.dataclass
class TrainState:
    actors: List[AgentTrainState]
    critic: AgentTrainState
    value_norm: Optional[ValueNormState]
    carry: RolloutCarry


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
        self.max_grad_norm = (al.get("max_grad_norm", 10.0)
                              if al.get("use_max_grad_norm", True) else None)
        self.use_linear_lr_decay = tr.get("use_linear_lr_decay", False)

        if env_args.get("state_type", "EP") != "EP":
            raise NotImplementedError(
                "the FP state layout is not ported yet (ROADMAP.md, recurrent "
                "discrete path)")
        env = make_env(args["env"], env_args, self.device)
        self.env = env
        self.vec = VecEnv(env, self.n_rollout_threads)
        self.n_agents = env.n_agents
        self.act_spaces = env.action_space
        self.obs_dims = [sp.shape[0] for sp in env.observation_space]
        self.share_obs_dim = env.share_observation_space[0].shape[0]

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
            device=self.device,
            generator=self.generator,
        )

    def _optimizer(self, net, lr: float):
        return make_optimizer(net.parameters(), lr, self.md.get("opti_eps", 1e-5),
                              self.md.get("weight_decay", 0.0), self.max_grad_norm,
                              self.use_linear_lr_decay)

    def init_state(self, seed: int) -> TrainState:
        """Seed the runner's generator, reset the envs, build fresh networks."""
        self.generator.manual_seed(seed)
        env_state, ts = self.vec.reset(self.noise)
        md = self.md
        actors = []
        for i in range(self.n_agents):
            policy = StochasticPolicy(
                self.obs_dims[i], self.act_spaces[i], gain=md.get("gain", 0.01),
                use_recurrent_policy=md.get("use_recurrent_policy", False)
                or md.get("use_naive_recurrent_policy", False),
                std_x_coef=md.get("std_x_coef", 1.0), **self._model_kwargs())
            actors.append(AgentTrainState(policy, self._optimizer(policy, md["lr"])))
        vnet = VNet(self.share_obs_dim, **self._model_kwargs())
        critic = AgentTrainState(vnet, self._optimizer(vnet, md["critic_lr"]))
        B, N = self.n_rollout_threads, self.n_agents
        ones = torch.ones((B, N, 1), device=self.device)
        carry = RolloutCarry(
            env_state=env_state, obs=ts.obs, share_obs=ts.share_obs,
            masks=ones, active_masks=ones.clone(),
            ep_ret=torch.zeros(B, device=self.device))
        vn = init_value_norm(1, device=self.device) if self.use_valuenorm else None
        return TrainState(actors, critic, vn, carry)

    # --------------------------------------------------------------- rollout
    def _policy_step(self, actors: List[AgentTrainState], carry: RolloutCarry):
        """All agents act once: (stacked padded actions, per-agent actions,
        per-agent log-probs)."""
        acts, logps = [], []
        for i, actor in enumerate(self.actors):
            head = actors[i].net(carry.obs[:, i, : self.obs_dims[i]])
            noise = self.noise.action_noise(head[0].shape)
            out = act_sample(noise, head, self.act_spaces[i],
                             std_x_coef=actor.std_x_coef, std_y_coef=actor.std_y_coef)
            acts.append(out.actions)
            logps.append(out.log_probs)
        max_da = max(a.shape[-1] for a in acts)
        stacked = torch.stack(
            [torch.nn.functional.pad(a, (0, max_da - a.shape[-1])) for a in acts], dim=1)
        return stacked, acts, logps

    def rollout_step(self, state: TrainState, carry: RolloutCarry):
        actions, acts, logps = self._policy_step(state.actors, carry)
        value = state.critic.net(carry.share_obs)                     # (B, 1)
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
        new_carry = RolloutCarry(
            env_state=tr.state, obs=ts.obs, share_obs=ts.share_obs,
            masks=new_masks, active_masks=new_active,
            ep_ret=torch.where(done_env, 0.0, ep_ret))
        step_data = dict(
            obs=carry.obs, share_obs=carry.share_obs, masks=carry.masks,
            active_masks=carry.active_masks, actions=acts, logp=logps, value=value,
            # EP: agent-0 (team) reward and masks, (B, 1)
            reward=ts.rewards[:, 0], next_masks=new_masks[:, 0],
            next_bad_masks=bad_mask, next_active=new_active,
            emitted_ret=torch.where(done_env, ep_ret, 0.0),
            emitted_cnt=done_env.to(torch.float32))
        return new_carry, step_data

    @torch.no_grad()
    def rollout(self, state: TrainState) -> Dict[str, Any]:
        """``episode_length`` steps from ``state.carry``; advances the carry
        and returns the time-major data (per-agent lists for actions/logp)."""
        carry, steps = state.carry, []
        for _ in range(self.episode_length):
            carry, step = self.rollout_step(state, carry)
            steps.append(step)
        state.carry = carry
        data = {k: torch.stack([s[k] for s in steps]) for k in steps[0]
                if k not in ("actions", "logp")}
        for k in ("actions", "logp"):
            data[k] = [torch.stack([s[k][i] for s in steps]) for i in range(self.n_agents)]
        return data

    # ------------------------------------------------------------- iteration
    def train_iteration(self, state: TrainState):
        """One rollout + update; updates ``state`` in place, returns
        (state, metrics) with the metrics as tensors on the device."""
        first_masks0 = state.carry.masks[:, 0]
        data = self.rollout(state)
        metrics = self.update_phase(state, data, first_masks0, state.carry.share_obs)
        return state, metrics

    @torch.no_grad()
    def compute_returns(self, state: TrainState, data, first_masks0, last_share_obs):
        """(returns, de-normalized values (T+1, B, 1)) for the rollout."""
        next_value = state.critic.net(last_share_obs)
        values = torch.cat([data["value"], next_value[None]], dim=0)
        values_den = (denormalize(state.value_norm, values)
                      if state.value_norm is not None else values)
        B = data["reward"].shape[1]
        masks_tb = torch.cat([first_masks0[None], data["next_masks"]], dim=0)
        bad_tb = torch.cat([torch.ones((1, B, 1), device=self.device),
                            data["next_bad_masks"]], dim=0)
        bad = bad_tb if self.use_proper_time_limits else None
        if self.use_gae:
            returns = compute_gae(data["reward"], values_den, masks_tb, bad,
                                  self.gamma, self.gae_lambda)
        else:
            returns = compute_discounted_returns(data["reward"], values_den, masks_tb, bad,
                                                 values_den[-1], self.gamma)
        return returns, values_den

    def update_phase(self, state: TrainState, data, first_masks0, last_share_obs):
        """Returns + sequential actor update + critic train (in place)."""
        T, B, N = data["reward"].shape[0], data["reward"].shape[1], self.n_agents
        returns, values_den = self.compute_returns(state, data, first_masks0, last_share_obs)
        advantages = returns - values_den[:-1]                        # (T, B, 1)
        batches = [
            ActorBatch(obs=data["obs"][:, :, i, : self.obs_dims[i]],
                       actions=data["actions"][i], logp=data["logp"][i],
                       active_masks=data["active_masks"][:, :, i])
            for i in range(N)
        ]
        actor_stats = self._sequential_update(state, batches, advantages, T, B)
        critic_batch = CriticBatch(share_obs=data["share_obs"], value_preds=data["value"],
                                   returns=returns)
        state.value_norm, critic_stats = self.critic.update(
            state.critic, state.value_norm, critic_batch,
            self._perms(self.critic.critic_epoch, self.critic.num_mini_batch, T * B))
        return dict(
            actor_stats=actor_stats,   # (N, [policy_loss, entropy, grad_norm, ratio])
            value_loss=critic_stats[0],
            critic_grad_norm=critic_stats[1],
            mean_step_reward=data["reward"].mean(),
            dead_ratio=1.0 - data["active_masks"].mean(),
            episode_return_sum=data["emitted_ret"].sum(),
            episode_count=data["emitted_cnt"].sum(),
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
                st, batch, advantages, factor,
                self._perms(actor.ppo_epoch, actor.num_mini_batch, T * B))
            new_logp = actor.evaluate_logp(st.net, batch)
            factor = factor * aggregate_ratio(
                new_logp - old_logp, self.action_aggregation).reshape(T, B, 1)
        return stats
