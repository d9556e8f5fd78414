"""Off-policy HARL runner (counterpart of ``harl_tpu/runners/off_policy.py``):
HASAC, HADDPG, HATD3, HAD3QN, MADDPG and MATD3 on one replay buffer.

  warmup_block  — ``warmup_steps // n_rollout_threads`` steps of uniform
                  random actions, inserted into the replay buffer;
  collect_block — ``train_interval`` steps of the exploration policies;
  train_block   — ``update_per_train × train_interval`` updates, each: an
                  n-step sample, the critic's TD step, and every
                  ``policy_freq`` updates the actors (sequential in random or
                  fixed order for HA algorithms, HAD3QN's a coordinate
                  descent on the joint critic's argmax; simultaneous against
                  the buffer's actions for MA ones) and the polyak target
                  updates.

Each block updates the state in place and returns it, with its metrics as
tensors on the device; no block waits on the device. Insert bookkeeping
(off_policy_base_runner.py:353-442): valid = 1 − agent deaths before the
step, terms = env done ∧ ¬truncation, next obs and state at an episode end
are the pre-reset ones (``Transition.final``), the EP reward is agent 0's,
and the episode return adds the mean reward over agents. Under discrete
actions each agent's availability before and after the step is kept too:
HASAC masks its logits with it, HAD3QN reads none.

Under an FP state (SMACLite ``state_type: FP``) the buffer is
``ReplayBufferFP``: each agent's state row, reward, done (the env's end or
its own death) and term go in, every agent walks its own n steps, and the
actor objectives tile the joint action (HASAC: also its log-probability
sum and the valid-transition mask) over the sample's agent-major rows, as
the critic does. HAD3QN's joint critic has no FP form; it refuses FP.

``run`` is the training loop around them: the warmup, then collect and
train blocks, a log record (with an evaluation under ``use_eval``) every
``eval_interval // train_interval`` blocks and a checkpoint every five such
intervals, keeping the newest two (the state holds the replay buffer), and a
resume from ``model_dir``.

Ported: the EP and FP states, Box, Discrete and (HASAC) MultiDiscrete
actions, pure-tensor envs, host envs (below), ``share_param`` (one actor
state and optimizer for every agent: each agent's step in the update order
moves it) and data parallelism (``run(mesh=…)``).

Host envs (``is_jax`` false; off_policy.py:118-135, 809-1093): the envs
step in NumPy on the host (``envs/host.py``; the native MuJoCo engine is
used whole), the actors and the updates on the device. ``_host_steps``
replaces the warmup and collect blocks: it steps the envs, keeps the rows
on the host and inserts them step-major in one batch, so consecutive steps
of an env stay ``n_rollout_threads`` rows apart as the n-step walk needs;
under discrete actions the availability after a step is the host env's
(post-reset where an env ended), as in the JAX package. ``host_eval`` runs
the deterministic actors on fresh host envs seeded from 50000 until
``eval_episodes`` episodes have ended. ``run`` enters the host loop before
any ``model_dir`` restore, as the JAX runner does (ROADMAP Queue C). FP
states and data parallelism over more than one rank refuse a host env.

Data parallelism (``parallel/mesh.py``), the JAX package's layout: the
replay buffer is replicated. Rank r of W steps its B/W env columns,
drawing every env-axis random number at the global B and keeping its rows;
each step's transitions are gathered over the ranks (``gather_rows``, one
all-reduce) and every rank inserts the same global rows, so the buffers
stay equal to the one-rank run's. Every rank draws the same sample
indices; rank r trains on its block of the sample's rows, with the
sample-axis draws (HASAC's, the target smoothing normals) made at the
global batch and cut the same way, every mean a sum over the global count
(the FP valid-transition count all-reduced), and the gradients summed over
the ranks before each Adam step. The collect block's metrics are global.
Rank 0 alone evaluates, logs and writes checkpoints.

Randomness comes from one ``torch.Generator`` per runner on its device, and
one on the host for the agent orders, both seeded by ``init_state(seed)``,
through a noise source (``utils/noise.py``). Its draws, in order:

  init_state      the env reset (none for a host env);
  warmup, a step  per agent ``uniform((B, d_i))`` (Box), ``randint((B, 1), n_i)``
                  (Discrete) or one ``randint((B,), n_ij)`` a sub-action
                  (MultiDiscrete), then the env's reset draws (none for a host
                  env);
  collect, a step per agent its exploration draws, then the env's reset draws
                  (none for a host env):
                  ``action_noise((B, d_i))`` (Box), HASAC's
                  ``gumbel_noise((B, n_i))`` (Discrete) or one
                  ``gumbel_noise((B, n_ij))`` a sub-head (MultiDiscrete), HAD3QN's
                  ``randint((B, 1), n_i)`` and ``uniform((B, 1))``;
  train, an update
                  ``indices(batch_size, rows written)``; the next-action
                  draws of HASAC (normals (batch, d_i), or Gumbels
                  (batch, n_i), one a sub-head for MultiDiscrete) or target
                  smoothing normals (HATD3, MATD3)
                  in agent order; then, on a policy step, HASAC's
                  initial-action draws in agent order, the agent permutation
                  (HA algorithms and HAD3QN, unless ``fixed_order``), and
                  HASAC's draw of agent i in update order, used both for
                  its loss and for its action after its step.

HADDPG and HAD3QN draw nothing in an update but the indices and the
permutation; MADDPG draws only the indices. Evaluation draws from a
generator of its own, seeded from the run's seed and the round
(``runners/common.py``): the eval envs' reset, then each step's reset draws.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch

from harl_tpu_torch.algos.common import adam, soft_update
from harl_tpu_torch.algos.off_policy_actors import (HAD3QNActor, HADDPGActor, HASACActor,
                                                    HATD3Actor, OffPolicyAgentState)
from harl_tpu_torch.algos.q_critics import (ContinuousQCritic, DiscreteQCritic, QCriticState,
                                            SoftTwinContinuousQCritic, TwinContinuousQCritic)
from harl_tpu_torch.buffers.off_policy import ReplayBuffer, ReplayBufferFP, Sample
from harl_tpu_torch.envs import make_env
from harl_tpu_torch.envs.host import vectorize
from harl_tpu_torch.parallel.mesh import ShardedNoise, gather_tree, shard_tree
from harl_tpu_torch.runners import common
from harl_tpu_torch.utils import checkpoint
from harl_tpu_torch.utils.device import DeviceLike, resolve_device
from harl_tpu_torch.utils.noise import GeneratorNoise

ACTOR_REGISTRY = {"haddpg": HADDPGActor, "hatd3": HATD3Actor, "hasac": HASACActor,
                  "had3qn": HAD3QNActor, "maddpg": HADDPGActor, "matd3": HATD3Actor}
CRITIC_REGISTRY = {"haddpg": ContinuousQCritic, "maddpg": ContinuousQCritic,
                   "hatd3": TwinContinuousQCritic, "matd3": TwinContinuousQCritic,
                   "hasac": SoftTwinContinuousQCritic, "had3qn": DiscreteQCritic}
MA_ALGOS = ("maddpg", "matd3")          # simultaneous updates with buffer actions
SMOOTHED = ("hatd3", "matd3")           # target smoothing noise


class OffRolloutCarry(NamedTuple):
    env_state: Any
    obs: torch.Tensor            # (B, N, max_obs)
    share_obs: torch.Tensor      # (B, ds)
    avail: Optional[torch.Tensor]  # (B, N, max n_i) under discrete actions, else None
    agent_deaths: torch.Tensor   # (B, N, 1)
    ep_ret: torch.Tensor         # (B,)


@dataclasses.dataclass
class OffPolicyState:
    actors: List[OffPolicyAgentState]
    critic: QCriticState
    buffer: ReplayBuffer
    carry: OffRolloutCarry
    total_it: int = 0            # updates so far, a host int


class OffPolicyRunner:
    """``args``: {"algo", "env", …}; ``algo_args``: the YAML sections
    (train/model/algo); ``env_args``: env kwargs. ``device`` is CUDA unless
    given; ``noise`` replaces the generator-backed noise source; ``env``
    replaces the env that ``args`` and ``env_args`` name (a host env's
    further envs are still made from them)."""

    def __init__(self, args: dict, algo_args: dict, env_args: dict,
                 device: DeviceLike = None, noise=None, env=None):
        self.device = resolve_device(device)
        self.args, self.algo_args, self.env_args = args, algo_args, env_args
        self.algo = args["algo"]
        if self.algo not in ACTOR_REGISTRY:
            raise NotImplementedError(f"off-policy algo {self.algo!r} is unknown")
        tr, al, md = algo_args["train"], algo_args["algo"], algo_args["model"]
        self.n_rollout_threads = tr["n_rollout_threads"]
        self.num_env_steps = tr["num_env_steps"]
        self.warmup_steps = tr.get("warmup_steps", 10000)
        self.train_interval = tr.get("train_interval", 50)
        self.update_per_train = tr.get("update_per_train", 1)
        self.use_proper_time_limits = tr.get("use_proper_time_limits", True)
        self.batch_size = al["batch_size"]
        self.buffer_size = al["buffer_size"]
        self.n_step = al.get("n_step", 1)
        self.gamma = al.get("gamma", 0.99)
        self.policy_freq = al.get("policy_freq", 1)
        self.fixed_order = al.get("fixed_order", False)
        self.use_policy_active_masks = al.get("use_policy_active_masks", True)
        self.auto_alpha = al.get("auto_alpha", False)
        self.alpha_fixed = al.get("alpha", 0.2)
        self.alpha_lr = al.get("alpha_lr", 3e-4)
        self.share_param = al.get("share_param", False)
        env = make_env(args["env"], env_args, self.device) if env is None else env
        self.env = env
        self.host_mode = not getattr(env, "is_jax", True)
        if self.host_mode:
            self.host_vec = vectorize(env, args["env"], env_args, self.n_rollout_threads)
        self.n_agents = env.n_agents
        self.act_spaces = env.action_space
        self.obs_dims = [sp.shape[0] for sp in env.observation_space]
        self.share_obs_dim = env.share_observation_space[0].shape[0]
        self.fp = getattr(env, "state_type", env_args.get("state_type", "EP")) == "FP"
        if self.fp and getattr(env, "fp_state_dim", None) is None:
            # the JAX runner cannot run it either (on_policy.py:245)
            raise ValueError(f"state_type FP: {args['env']} has no FP state")
        if self.fp and self.algo == "had3qn":
            # the joint-action DiscreteQCritic has no FP form (off_policy.py:143-149)
            raise ValueError("off-policy FP: had3qn's joint critic has no FP form")

        cfg = {**al, **md, "use_proper_time_limits": self.use_proper_time_limits,
               "use_valuenorm": tr.get("use_valuenorm", False),
               "_fp_agents": self.n_agents if self.fp else 1}
        if self.share_param:
            # homogeneity check (off_policy.py:156-160)
            if not (all(d == self.obs_dims[0] for d in self.obs_dims)
                    and all(sp == self.act_spaces[0] for sp in self.act_spaces)):
                raise ValueError("share_param requires homogeneous agents")
            self.actors = [ACTOR_REGISTRY[self.algo](self.obs_dims[0], self.act_spaces[0], cfg,
                                                     self.device)] * self.n_agents
        else:
            self.actors = [ACTOR_REGISTRY[self.algo](self.obs_dims[i], self.act_spaces[i], cfg,
                                                     self.device)
                           for i in range(self.n_agents)]
        self.discrete = self.actors[0].kind == "Discrete"
        self.act_dims = [actor.act_dim for actor in self.actors]
        self.critic = CRITIC_REGISTRY[self.algo](self.share_obs_dim, self.act_spaces, cfg,
                                                 self.device)
        # HASAC's target entropy per agent: −dim of a Box, −0.98·log(1/n) of
        # a Discrete space, Σᵢ −0.98·log(1/nᵢ) of a MultiDiscrete one
        # (off_policy.py:175-187)
        self.target_entropy = [
            -float(actor.act_dim) if actor.kind == "Box"
            else sum(-0.98 * math.log(1.0 / int(n)) for n in (
                (actor.action_space.n,) if actor.kind == "Discrete" else actor.action_space.nvec))
            for actor in self.actors]
        self.generator = torch.Generator(device=self.device)
        self.host_generator = torch.Generator()
        self.base_noise = noise if noise is not None else GeneratorNoise(
            self.generator, self.device, self.host_generator)
        self.use_mesh(None)
        self.seed = 0

    def use_mesh(self, mesh) -> None:
        """Take the rank's env columns and its block of each sample's rows
        (``batch_local`` of ``batch_size``) under a data-parallel ``mesh``,
        or all of them for None (``LOCAL``); ``run(mesh=…)`` calls it."""
        common.attach_mesh(self, mesh)
        self.sample_rows = self.mesh.row_range(self.batch_size)
        self.sample_noise = ShardedNoise(self.base_noise, self.mesh, self.batch_size)
        self.batch_local = self.sample_rows[1] - self.sample_rows[0]

    def _sidx(self, i: int) -> int:
        """Agent i's entry of ``OffPolicyState.actors``."""
        return 0 if self.share_param else i
    # ------------------------------------------------------------------ init
    def init_state(self, seed: int) -> OffPolicyState:
        """Seed the generator, reset the envs, build fresh networks (targets
        equal to them) and an empty replay buffer."""
        self.generator.manual_seed(seed)
        self.host_generator.manual_seed(seed)
        if self.host_mode:
            env_state, ts = None, common.host_timestep(*self.vec.reset(), self.device)
        else:
            env_state, ts = self.vec.reset(self.noise)
        return self.new_state(self.generator, env_state, ts)

    def new_state(self, generator: torch.Generator, env_state, ts) -> OffPolicyState:
        """Fresh networks drawn from ``generator`` (targets equal to them),
        an empty replay buffer and the carry of the reset ``(env_state, ts)``."""
        actors = []
        for actor in self.actors[:1 if self.share_param else self.n_agents]:
            st = actor.init(generator, self.mesh)
            if self.algo == "hasac" and self.auto_alpha:
                st.log_alpha = torch.zeros((), device=self.device, requires_grad=True)
                st.alpha_opt = adam([st.log_alpha], self.alpha_lr, self.mesh)
            actors.append(st)
        critic = self.critic.init(generator, self.mesh)
        B, N = self.n_envs, self.n_agents
        ring, dims, avail = self._ring_spec()
        buf = ring(*dims, device=self.device, avail_dims=avail)
        carry = OffRolloutCarry(env_state=env_state, obs=ts.obs, share_obs=self._state(ts),
                                avail=ts.available_actions,
                                agent_deaths=torch.zeros((B, N, 1), device=self.device),
                                ep_ret=torch.zeros(B, device=self.device))
        return OffPolicyState(actors, critic, buf, carry)

    def _ring_spec(self) -> tuple:
        """(the replay ring's class, its dimensions, its availability widths
        or None), as ``init_state`` builds it."""
        dims = ((self.buffer_size,) + ((self.n_agents,) if self.fp else ())
                + (self.share_obs_dim, self.obs_dims, self.act_dims))
        avail = [sp.n for sp in self.act_spaces] if self.discrete else None
        return (ReplayBufferFP if self.fp else ReplayBuffer), dims, avail

    def ring_nbytes(self) -> int:
        """The bytes of the replay ring that ``init_state`` allocates."""
        ring, dims, avail = self._ring_spec()
        return ring.ring_nbytes(*dims, avail_dims=avail)

    # --------------------------------------------------------------- helpers
    def _alpha(self, st) -> Any:
        """α of an actor (its log α under auto-α) or of the critic."""
        if self.auto_alpha:
            return torch.exp(st.log_alpha.detach())
        return self.alpha_fixed

    def _state(self, ts) -> torch.Tensor:
        """The state the buffer keeps: EP (B, ds), FP (B, N, ds)."""
        return ts.agent_state if self.fp else ts.share_obs

    def _obs_i(self, obs: torch.Tensor, i: int) -> torch.Tensor:
        return obs[:, i, : self.obs_dims[i]]

    def _avail_i(self, avail: Optional[torch.Tensor], i: int) -> Optional[torch.Tensor]:
        """Agent i's availability (B, n_i), or None (Box actions)."""
        if avail is None or self.actors[i].kind != "Discrete":
            return None
        return avail[:, i, : self.act_spaces[i].n]

    def _env_actions(self, actors: List[OffPolicyAgentState], carry: OffRolloutCarry):
        """Every agent's exploration action: (stacked (B, N, max d), per agent)."""
        B = self.n_envs
        acts = [actor.get_actions(actors[self._sidx(i)].net, self._obs_i(carry.obs, i),
                                  actor.explore_noise(self.noise, B),
                                  self._avail_i(carry.avail, i))
                for i, actor in enumerate(self.actors)]
        return common.stack_actions(acts), acts

    def _random_actions(self):
        acts = [actor.random_actions(self.noise, self.n_envs) for actor in self.actors]
        return common.stack_actions(acts), acts

    def _env_step_insert(self, state: OffPolicyState, stacked: torch.Tensor,
                         acts: List[torch.Tensor]):
        """Step the envs, insert the step; returns (episode returns emitted,
        episodes ended, mean step reward), each on the device."""
        carry, N = state.carry, self.n_agents
        tr = self.vec.step(carry.env_state, stacked, self.noise)
        ts, final = tr.ts, tr.final
        done_env = final.dones.all(dim=1, keepdim=True).to(torch.float32)       # (B, 1)
        terms = done_env * (1.0 - final.bad_transition.to(torch.float32)[:, None])
        valid = 1.0 - carry.agent_deaths                                       # (B, N, 1)
        dones_agent = final.dones[..., None].to(torch.float32)                # (B, N, 1)
        new_deaths = torch.where(done_env[:, :, None] > 0, 0.0, dones_agent)
        if self.fp:
            # per agent: its reward, its done (the env's end or its death)
            # and term (off_policy_base_runner.py FP branch)
            rewards, dones = final.rewards, dones_agent
            terms = dones_agent * (1.0 - final.bad_transition.to(torch.float32)[:, None, None])
        else:
            rewards, dones = final.rewards[:, 0], done_env
        batch = dict(
            share_obs=carry.share_obs,
            obs=[self._obs_i(carry.obs, i) for i in range(N)],
            actions=acts,
            rewards=rewards,
            dones=dones,
            valid_transitions=[valid[:, i] for i in range(N)],
            terms=terms,
            next_share_obs=self._state(final),
            next_obs=[self._obs_i(final.obs, i) for i in range(N)])
        if state.buffer.available_actions is not None:
            batch.update(
                available_actions=[self._avail_i(carry.avail, i) for i in range(N)],
                next_available_actions=[self._avail_i(final.available_actions, i)
                                        for i in range(N)])
        # every rank's rows, in one all-reduce; the buffer stores floats, so
        # integer actions travel as (exact) floats
        batch = gather_tree(self.mesh, {
            k: [x.to(torch.float32) for x in v] if isinstance(v, list)
            else v.to(torch.float32) for k, v in batch.items()})
        state.buffer.insert(batch)
        done = done_env[:, 0] > 0
        ep_ret = carry.ep_ret + final.rewards[:, :, 0].mean(dim=1)
        state.carry = OffRolloutCarry(env_state=tr.state, obs=ts.obs, share_obs=self._state(ts),
                                      avail=ts.available_actions, agent_deaths=new_deaths,
                                      ep_ret=torch.where(done, 0.0, ep_ret))
        return torch.where(done, ep_ret, 0.0), done.to(torch.float32), final.rewards.mean()

    # ---------------------------------------------------------------- blocks
    @torch.no_grad()
    def warmup_block(self, state: OffPolicyState) -> OffPolicyState:
        """Fill the buffer with uniform random actions."""
        steps = max(self.warmup_steps // self.n_rollout_threads, 1)
        if self.host_mode:
            return self._host_steps(state, steps, warmup=True)[0]
        for _ in range(steps):
            self._env_step_insert(state, *self._random_actions())
        return state

    @torch.no_grad()
    def collect_block(self, state: OffPolicyState):
        """``train_interval`` exploration steps with inserts."""
        if self.host_mode:
            return self._host_steps(state, self.train_interval)
        emitted, counts, rewards = [], [], []
        for _ in range(self.train_interval):
            e, c, r = self._env_step_insert(state, *self._env_actions(state.actors,
                                                                      state.carry))
            emitted.append(e)
            counts.append(c)
            rewards.append(r)
        sums = [torch.stack(emitted).sum(), torch.stack(counts).sum(), torch.stack(rewards).mean()]
        # the ranks hold as many envs: the global mean reward is the mean of
        # theirs
        sums = self.mesh.all_reduce_sum(sums)
        sums[2] = sums[2] / self.mesh.world
        return state, dict(episode_return_sum=sums[0], episode_count=sums[1],
                           mean_step_reward=sums[2])

    @torch.no_grad()
    def _host_steps(self, state: OffPolicyState, n_steps: int, warmup: bool = False):
        """``n_steps`` steps of the host envs with random (``warmup``) or
        exploration actions, inserted step-major in one batch at the end
        (off_policy.py:809-897). Returns (state, the collect metrics): the
        episode returns summed in a Python float, as float32 tensors."""
        B, N, dev = self.n_envs, self.n_agents, self.device
        carry = state.carry
        obs, share = carry.obs.cpu().numpy(), carry.share_obs.cpu().numpy()
        avail = None if carry.avail is None else carry.avail.cpu().numpy()
        ep_ret, deaths = carry.ep_ret.cpu().numpy(), carry.agent_deaths.cpu().numpy()
        keep_avail = state.buffer.available_actions is not None and avail is not None
        rows = {k: [] for k in ("share_obs", "rewards", "dones", "terms", "next_share_obs")}
        per_agent = {k: [[] for _ in range(N)] for k in (
            "obs", "next_obs", "actions", "valid_transitions", "available_actions",
            "next_available_actions")}
        emitted = counts = 0.0
        for _ in range(n_steps):
            stacked, _ = (self._random_actions() if warmup
                          else self._env_actions(state.actors, carry))
            stacked = stacked.cpu().numpy()
            res = self.vec.step(stacked)
            dones = res["dones"]
            done_env = dones.all(axis=1)
            bad = np.array([bool(info[0].get("bad_transition", False)) for info in res["infos"]])
            valid = 1.0 - deaths
            deaths = np.where(dones[..., None], 1.0, 0.0)
            deaths[done_env] = 0.0
            for k, v in (("share_obs", share), ("rewards", res["rewards"][:, 0]),
                         ("dones", done_env[:, None]), ("terms", (done_env & ~bad)[:, None]),
                         ("next_share_obs", common.host_state(res["final_share_obs"]))):
                rows[k].append(v)
            for i in range(N):
                do, pa = self.obs_dims[i], per_agent
                pa["obs"][i].append(obs[:, i, :do])
                pa["next_obs"][i].append(res["final_obs"][:, i, :do])
                pa["actions"][i].append(stacked[:, i, : self.act_dims[i]])
                pa["valid_transitions"][i].append(valid[:, i])
                if keep_avail:
                    n = self.act_spaces[i].n
                    pa["available_actions"][i].append(avail[:, i, :n])
                    pa["next_available_actions"][i].append(res["available_actions"][:, i, :n])
            ep_ret = ep_ret + res["rewards"][:, :, 0].mean(axis=1)
            emitted += float(ep_ret[done_env].sum())
            counts += float(done_env.sum())
            ep_ret[done_env] = 0.0
            obs, share, avail = (res["obs"], common.host_state(res["share_obs"]),
                                 res["available_actions"])
            carry = OffRolloutCarry(
                env_state=None, obs=common.host_tensor(obs, dev),
                share_obs=common.host_tensor(share, dev), avail=common.host_tensor(avail, dev),
                agent_deaths=common.host_tensor(deaths, dev), ep_ret=common.host_tensor(ep_ret, dev))
        state.carry = carry
        batch = {k: common.host_tensor(np.concatenate(v), dev) for k, v in rows.items()}
        for k, v in per_agent.items():
            if v[0]:
                batch[k] = [common.host_tensor(np.concatenate(x), dev) for x in v]
        total, S = n_steps * B, state.buffer.buffer_size
        for lo in range(0, total, S):     # a ring of S rows takes at most S at a time
            state.buffer.insert({k: [x[lo: lo + S] for x in v] if isinstance(v, list)
                                 else v[lo: lo + S] for k, v in batch.items()})
        metrics = dict(episode_return_sum=emitted, episode_count=counts,
                       mean_step_reward=float(np.mean(np.stack(rows["rewards"]))))
        return state, {k: torch.tensor(v, dtype=torch.float32, device=dev)
                       for k, v in metrics.items()}

    def train_block(self, state: OffPolicyState):
        """``update_per_train × train_interval`` updates; the metrics hold the
        mean critic loss."""
        losses = [self.update(state) for _ in range(self.update_per_train * self.train_interval)]
        (loss,) = self.mesh.all_reduce_sum([torch.stack(losses).mean()])   # shares add up
        return state, dict(critic_loss=loss)

    def update(self, state: OffPolicyState) -> torch.Tensor:
        """One update (one iteration of the JAX ``train_block``'s scan);
        returns the critic loss (this rank's share)."""
        start = self.noise.indices(self.batch_size, max(state.buffer.cur_size, 1))
        lo, hi = self.sample_rows
        sp = state.buffer.sample(self.batch_local, self.n_step, self.gamma,
                                 self.n_rollout_threads, start=start[lo:hi])
        state.total_it += 1
        actors = [state.actors[self._sidx(i)] for i in range(self.n_agents)]
        B, rows = self.batch_local, self._rows()
        if self.algo == "hasac":
            with torch.no_grad():
                next_acts, next_logps = [], []
                for i, actor in enumerate(self.actors):
                    a, lp = actor.get_actions_with_logprobs(
                        actors[i].net, sp.next_obs[i], actor.draw(self.sample_noise, B),
                        _at(sp.next_available_actions, i))
                    next_acts.append(a)
                    next_logps.append(lp)
                next_logp = torch.cat(next_logps, dim=-1).sum(dim=-1, keepdim=True)
            loss = self.critic.train(state.critic, sp, torch.cat(next_acts, dim=-1), next_logp,
                                     self._alpha(state.critic), self.mesh, rows)
        elif self.algo == "had3qn":
            with torch.no_grad():
                next_acts = [actor.get_target_actions(actors[i].target, sp.next_obs[i])
                             for i, actor in enumerate(self.actors)]
            loss = self.critic.train(state.critic, sp, next_acts, self.mesh, rows)
        else:
            with torch.no_grad():
                next_acts = []
                for i, actor in enumerate(self.actors):
                    noise = (self.sample_noise.action_noise((B, self.act_dims[i]))
                             if self.algo in SMOOTHED else None)
                    next_acts.append(actor.get_target_actions(actors[i].target, sp.next_obs[i],
                                                              noise))
            loss = self.critic.train(state.critic, sp, torch.cat(next_acts, dim=-1),
                                     mesh=self.mesh, rows=rows)
        if state.total_it % self.policy_freq == 0:
            self._policy_update(state, sp)
        return loss

    # ------------------------------------------------- per-algo actor update
    def _rows(self, tiled: bool = True) -> int:
        """Global rows of a sample's env-level fields (``tiled``: N·batch
        under FP) or of its per-agent fields."""
        return self.batch_size * (self.n_agents if tiled and self.fp else 1)

    def _mean(self, x: torch.Tensor, tiled: bool = True) -> torch.Tensor:
        """The mean over a sample's rows: this rank's sum over the global
        count."""
        return x.sum() / (self._rows(tiled) * x.shape[-1])

    def _policy_update(self, state: OffPolicyState, sp: Sample) -> None:
        if self.algo == "hasac":
            self._hasac_update(state, sp)
        elif self.algo == "had3qn":
            self._had3qn_update(state, sp)
        elif self.algo in MA_ALGOS:
            self._ma_update(state, sp)
        else:
            self._ha_update(state, sp)
        # soft updates (off_policy_ha_runner.py:236-239)
        for st in state.actors:
            soft_update(st.target, st.net, self.actors[0].polyak)
        self.critic.soft_update_targets(state.critic)

    def _step_actor(self, st: OffPolicyAgentState, loss: torch.Tensor) -> None:
        """An Adam step of the actor on ``loss``, with gradients taken for
        the actor's parameters only (the loss runs through the critic)."""
        params = list(st.net.parameters())
        for p, g in zip(params, torch.autograd.grad(loss, params)):
            p.grad = g
        st.opt.step()

    def _joint(self, actions: List[torch.Tensor], i: int, a_i: torch.Tensor) -> torch.Tensor:
        """The joint action with agent i's replaced, tiled over the agent-major
        rows of an FP sample."""
        return self._tile(torch.cat([a_i if j == i else a for j, a in enumerate(actions)],
                                    dim=-1))

    def _tile(self, x: torch.Tensor) -> torch.Tensor:
        """(batch, ·) → (N·batch, ·) under FP (off_policy_ha_runner.py:113-146)."""
        return x.repeat(self.n_agents, 1) if self.fp else x

    def _order(self) -> List[int]:
        if self.fixed_order or self.n_agents == 1:
            return list(range(self.n_agents))
        return self.noise.permutation(self.n_agents).tolist()

    def _ha_update(self, state: OffPolicyState, sp: Sample) -> None:
        """HADDPG/HATD3 sequential updates (off_policy_ha_runner.py:206-235)."""
        with torch.no_grad():
            actions = [self.actors[i].get_actions(state.actors[self._sidx(i)].net, sp.obs[i])
                       for i in range(self.n_agents)]
        for i in self._order():
            actor, st = self.actors[i], state.actors[self._sidx(i)]
            joint = self._joint(actions, i, actor.get_actions(st.net, sp.obs[i]))
            self._step_actor(st, -self._mean(self.critic.get_values(state.critic, sp.share_obs,
                                                                    joint)))
            with torch.no_grad():
                actions[i] = actor.get_actions(st.net, sp.obs[i])

    def _ma_update(self, state: OffPolicyState, sp: Sample) -> None:
        """MADDPG/MATD3: simultaneous; the other agents take the buffer's
        actions (off_policy_ma_runner.py:50-57)."""
        for i, actor in enumerate(self.actors):
            st = state.actors[self._sidx(i)]
            joint = self._joint(sp.actions, i, actor.get_actions(st.net, sp.obs[i]))
            self._step_actor(st, -self._mean(self.critic.get_values(state.critic, sp.share_obs,
                                                                    joint)))

    def _hasac_update(self, state: OffPolicyState, sp: Sample) -> None:
        """HASAC sequential updates with per-agent and critic-side α
        (off_policy_ha_runner.py:80-172)."""
        B = self.batch_local
        with torch.no_grad():
            init = [self.actors[i].get_actions_with_logprobs(
                state.actors[self._sidx(i)].net, sp.obs[i],
                self.actors[i].draw(self.sample_noise, B), _at(sp.available_actions, i))
                for i in range(self.n_agents)]
        actions = [a for a, _ in init]
        logps = [lp for _, lp in init]
        for i in self._order():
            actor, st = self.actors[i], state.actors[self._sidx(i)]
            alpha_i = self._alpha(st)
            avail_i = _at(sp.available_actions, i)
            eps_i = actor.draw(self.sample_noise, B)   # loss and re-sample
            a_i, lp_i = actor.get_actions_with_logprobs(st.net, sp.obs[i], eps_i, avail_i)
            q = self.critic.get_values(state.critic, sp.share_obs, self._joint(actions, i, a_i))
            obj = q - alpha_i * self._tile(lp_i.sum(dim=-1, keepdim=True))
            if self.use_policy_active_masks:
                vt = self._tile(sp.valid_transitions[i])
                (denom,) = self.mesh.all_reduce_sum([vt.sum()])
                loss = -(obj * vt).sum() / torch.clamp(denom, min=1e-9)
            else:
                loss = -self._mean(obj)
            self._step_actor(st, loss)
            if self.auto_alpha:
                target = lp_i.detach().sum(dim=-1, keepdim=True) + self.target_entropy[i]
                alpha_loss = -self._mean(st.log_alpha * target, tiled=False)
                st.alpha_opt.zero_grad(set_to_none=True)
                alpha_loss.backward()
                st.alpha_opt.step()
                with torch.no_grad():
                    st.log_alpha.clamp_(-16.0, 2.0)
            with torch.no_grad():
                actions[i], logps[i] = actor.get_actions_with_logprobs(st.net, sp.obs[i], eps_i,
                                                                       avail_i)
        if self.auto_alpha:
            logp_sum = torch.cat(logps, dim=-1).sum(dim=-1, keepdim=True)
            self.critic.update_alpha(state.critic, logp_sum, float(sum(self.target_entropy)),
                                     rows=self._rows(tiled=False))

    def _had3qn_update(self, state: OffPolicyState, sp: Sample) -> None:
        """Coordinate descent on the joint critic's argmax
        (off_policy_ha_runner.py:174-205): each agent in turn regresses its
        Q(o, aᵢ) onto the critic's Q(s, a) at the current joint action, then
        takes the argmax of the critic over its own actions, the others held."""
        critic = self.critic
        with torch.no_grad():
            all_values = critic.q_all(state.critic.nets, sp.share_obs)
            actions = [actor.get_actions(state.actors[self._sidx(i)].net, sp.obs[i])
                       for i, actor in enumerate(self.actors)]
        for i in self._order():
            actor, st = self.actors[i], state.actors[self._sidx(i)]
            critic_values = torch.take_along_dim(all_values, critic.indiv_to_joint(actions),
                                                 dim=-1)
            av = actor.train_values(st.net, sp.obs[i], actions[i])
            self._step_actor(st, self._mean((av - critic_values) ** 2))
            vals = torch.take_along_dim(all_values, critic.get_joint_idx(actions, i), dim=-1)
            actions[i] = torch.argmax(vals, dim=-1, keepdim=True)

    # ------------------------------------------------------------------ eval
    def eval_noise(self, round_idx: int):
        """The noise source of evaluation round ``round_idx``."""
        return common.derived_noise(self.seed, common.OFF_POLICY_EVAL_SALT, round_idx,
                                    self.device)

    def eval_rollout(self, state: OffPolicyState, n_eval_envs: int, round_idx: int = 0):
        """The deterministic actors over one env horizon of ``n_eval_envs``
        auto-reset envs (off_policy.py:725-780); returns the sums (episode
        return, episodes ended, {metric: sum}) as tensors."""
        def act(obs, avail, masks, rnn):
            return common.stack_actions([
                actor.deterministic_actions(state.actors[self._sidx(i)].net, self._obs_i(obs, i),
                                            self._avail_i(avail, i))
                for i, actor in enumerate(self.actors)]), None

        return common.eval_rollout(self.env, n_eval_envs, self._eval_len(),
                                   self.eval_noise(round_idx), act)

    def evaluate(self, state: OffPolicyState, n_eval: int, eval_episodes: int):
        """Rounds of ``eval_rollout`` until ``eval_episodes`` episodes ended;
        returns (mean return, metrics)."""
        return common.evaluate_rounds(lambda r: self.eval_rollout(state, n_eval, r),
                                      n_eval, eval_episodes)

    def _eval_len(self) -> int:
        return common.eval_len(self.env, 1000)

    @torch.no_grad()
    def host_eval(self, state: OffPolicyState, n_episodes: int = 10) -> float:
        """The mean return of the first ``n_episodes`` episodes to end on
        ``min(n_episodes, 10)`` fresh auto-reset host envs seeded from 50000,
        under the deterministic actors (off_policy.py:899-950), within
        ``episode_limit · (n_episodes // n_envs + 2)`` steps; nan if none
        ended."""
        n_envs = min(n_episodes, 10)
        vec = vectorize(make_env(self.args["env"], self.env_args), self.args["env"],
                        self.env_args, n_envs, seed=50000)
        obs, _, avail = vec.reset()
        ep_ret = np.zeros(n_envs)                    # float64, as in the JAX package
        returns: List[float] = []
        limit = getattr(self.env, "episode_limit", 1000)
        for _ in range(limit * (n_episodes // n_envs + 2)):
            obs_t, avail_t = (common.host_tensor(x, self.device) for x in (obs, avail))
            stacked = common.stack_actions([
                actor.deterministic_actions(state.actors[self._sidx(i)].net,
                                            self._obs_i(obs_t, i), self._avail_i(avail_t, i))
                for i, actor in enumerate(self.actors)])
            res = vec.step(stacked.cpu().numpy())
            done_env = res["dones"].all(axis=1)
            ep_ret += res["rewards"][:, :, 0].mean(axis=1)
            returns.extend(ep_ret[done_env].tolist())
            ep_ret[done_env] = 0.0
            if len(returns) >= n_episodes:
                break
            obs, avail = res["obs"], res["available_actions"]
        vec.close()
        return float(np.mean(returns)) if returns else math.nan

    # ----------------------------------------------------------- checkpoint
    def checkpoint(self, state: OffPolicyState) -> dict:
        """The full train state as a plain payload (``utils/checkpoint.py``):
        networks, targets, optimizers, α, the critic's ValueNorm, the replay
        buffer's tensors with its host ``idx``/``cur_size``, the rollout
        carry, the update count and both generators' states. The carry is
        every rank's env columns: the payload is the one-rank run's."""
        state = dataclasses.replace(state, carry=gather_tree(self.mesh, state.carry))
        return {"state": checkpoint.to_payload(state),
                "generator": self.generator.get_state(),
                "host_generator": self.host_generator.get_state(), "seed": self.seed}

    def load_checkpoint(self, state: OffPolicyState, payload: dict) -> OffPolicyState:
        """Load a payload of ``checkpoint`` into ``state``; each rank takes
        its env columns of the global carry."""
        payload = {**payload, "state": {**payload["state"], "carry": shard_tree(
            self.mesh, payload["state"]["carry"])}}
        state = checkpoint.load_payload(state, payload["state"])
        self.generator.set_state(payload["generator"].cpu())
        self.host_generator.set_state(payload["host_generator"].cpu())
        self.seed = int(payload["seed"])
        return state

    def restore(self, state: OffPolicyState, model_dir: str) -> OffPolicyState:
        """Resume the full state from the latest checkpoint under ``model_dir``.
        The file is memory-mapped and the replay ring's tensors are copied
        into in place (``utils/checkpoint.py``), so the device holds one
        ring throughout; the JAX runner restores into a target of the live
        state's shapes (off_policy.py:955-966)."""
        path = checkpoint.latest_checkpoint(model_dir) or model_dir
        print(f"restoring train state from {path}")
        return self.load_checkpoint(state, checkpoint.restore_state(path))

    # ------------------------------------------------------------------- run
    def run(self, seed: int = 1, logger=None, save_dir: Optional[str] = None, log_fn=None,
            mesh=None):
        """The training loop (off_policy.py:951-1035): the warmup, then
        ``num_env_steps // n_rollout_threads // train_interval`` collect and
        train blocks. Episode counts accumulate across blocks; every
        ``eval_interval // train_interval`` blocks and at the last, a log
        record (and an evaluation under ``use_eval``); every five such
        intervals and at the last, a checkpoint, keeping the newest two.
        Returns (state, the log records). With a ``mesh``
        (``parallel/mesh.py``) this process trains its rank's env columns;
        rank 0 alone evaluates, logs and writes, and every rank must get a
        ``save_dir`` where rank 0 does (the checkpoint gathers the carry).
        A host env skips ``model_dir`` and evaluates with ``host_eval``
        (off_policy.py:951-954, 1037-1093)."""
        self.use_mesh(mesh)
        main = self.mesh.is_main
        state = self.init_state(seed)
        tr, ev = self.algo_args["train"], self.algo_args.get("eval", {}) or {}
        if tr.get("model_dir") and not self.host_mode:
            state = self.restore(state, tr["model_dir"])
        state = self.warmup_block(state)
        total_blocks = max(int(self.num_env_steps) // self.n_rollout_threads
                           // self.train_interval, 1)
        blocks_per_eval = max(tr.get("eval_interval", 10000) // self.train_interval, 1)
        use_eval = ev.get("use_eval", False) and main
        n_eval = ev.get("n_eval_rollout_threads", 10)
        history: List[dict] = []
        t_start = time.time()
        last_return = math.nan
        acc_ret = acc_cnt = 0.0
        for block in range(1, total_blocks + 1):
            state, cm = self.collect_block(state)
            state, tm = self.train_block(state)
            acc_ret += float(cm["episode_return_sum"])
            acc_cnt += float(cm["episode_count"])
            if block % blocks_per_eval == 0 or block == total_blocks:
                if acc_cnt > 0:
                    last_return = acc_ret / acc_cnt
                    acc_ret = acc_cnt = 0.0
                steps = self.warmup_steps + block * self.train_interval * self.n_rollout_threads
                rec = dict(steps=steps, mean_episode_return=last_return,
                           critic_loss=float(tm["critic_loss"]),
                           fps=block * self.train_interval * self.n_rollout_threads
                           / (time.time() - t_start))
                if use_eval:
                    eval_episodes = ev.get("eval_episodes", n_eval)
                    eval_ret, extra = ((self.host_eval(state, eval_episodes), {})
                                       if self.host_mode
                                       else self.evaluate(state, n_eval, eval_episodes))
                    rec["eval_return"] = eval_ret
                    for k, v in extra.items():
                        rec["eval_win_rate" if k == "won" else f"eval_{k}"] = v
                history.append(rec)
                if logger is not None and main:
                    logger.log_episode(rec)
                if log_fn and main:
                    log_fn(rec)
                if save_dir is not None and (block % (blocks_per_eval * 5) == 0
                                             or block == total_blocks):
                    payload = self.checkpoint(state)
                    if main:
                        checkpoint.save_state(save_dir, payload, steps)
                        checkpoint.prune_checkpoints(save_dir, keep=2)
        return state, history


def _at(per_agent: Optional[List[torch.Tensor]], i: int) -> Optional[torch.Tensor]:
    return None if per_agent is None else per_agent[i]
