#!/usr/bin/env python3
"""A late-run block witness of the off-policy path: the JAX package's
``OffPolicyRunner`` and the port's, on the CPU, at the tuned config's full
widths, held one unit at a time.

    JAX_PLATFORMS=cpu python scripts/torch_offpolicy_witness.py
        [--blocks 12] [--late 410000:20000,810000:40000] [--log_alphas 0,-3,-6,-16]
        [--drift] [--small] [--out validation_torch/hasac_witness.json]

Run it from the root of the repository; it imports both packages and runs
on the CPU only. Both runners are built from the tuned HalfCheetah-6x1
HASAC config (``CONFIG``; the port's with ``device="cpu"``) and seeded with
``SEED``, and the port takes every draw from the JAX keys
(``tests/torch_replay.py``), so that a difference is the port's arithmetic
or logic and not its random numbers. A float32 run is chaotic over a
50-step collect (the planar physics) and over tens of updates, so each
unit starts both sides from the same state, the JAX runner's carried into
the port (``convert.off_policy_state`` and its parts):

  * a collect step: the JAX carry (env state, obs, episode returns) and
    the ring's cursor carried before each step, the networks once a block;
    held on the rows it inserts, the collect metrics and the carry after;
  * an update: every network, target, Adam state and α carried before it,
    the ring once a block (its rows of the block's collect, as JAX
    inserted them); held on the critic loss, every α and every parameter,
    target and Adam moment after it.

The JAX side of a unit is a second JAX runner of the same config whose
blocks are one step and one update long (``train_interval`` 1). The
states held: (a) every block from the first through ``--blocks`` after
the config's warmup (500 steps of 20 envs and ten blocks cross every env's
first 1,000-step truncation under ``n_step`` 10 in block 10); (b) late
states set on the state after (a): rings of the ``--late`` rows, filled
by repeating the collected rows whole in insertion order (each env's
stride and its done and term flags as inserted; the cursor at the head,
so that the windows sampled just below it walk into the newest rows),
each with its Adam count (every optimizer's), and every log α (per agent
and critic-side) at each of ``--log_alphas``: one collect and one train
block from each. With ``--drift``, the last block of (a) and the late
state of the largest ring at log α −6 are also run as whole blocks
without a resync (the JAX runner's own 50-step blocks, their draws
replayed), and how far the port drifts is reported with no pass rule.

An update with an element beyond its tolerance goes to a float64 referee
(``Ledger``): both packages run it again in float64 and must agree, and
the port's float32 value must be no farther from the float64 one than the
JAX runner's float32 value plus the tolerance, unless the port's float32
update took a decision (a ReLU, a log-std clamp, the twin critics'
minimum) the other way from its float64 update: a tie, which moves the
update by one sample's share whichever package's rounding crosses it.

The JSON at ``--out`` holds, per state and per quantity, the largest
absolute error, the largest error over its tolerance (``excess``: at most
1 passes) with the worst element's unit and index, the refereed elements
with both packages' distances from float64 and the ties of their units,
and the tolerance with its reason; the script exits non-zero if any
quantity fails.
``--small`` runs the same flow at test widths (a rehearsal of the script).
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import platform
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from harl_tpu.runners.off_policy import OffPolicyRunner as JRunner  # noqa: E402
from harl_tpu_torch import train  # noqa: E402
from harl_tpu_torch.algos.q_critics import ContinuousQCritic  # noqa: E402
from harl_tpu_torch.buffers.off_policy import AVAIL, ENV_LEVEL, PER_AGENT  # noqa: E402
from harl_tpu_torch.ops.distributions import LOG_STD_MAX, LOG_STD_MIN  # noqa: E402
from harl_tpu_torch.runners.off_policy import OffPolicyRunner  # noqa: E402
from harl_tpu_torch.utils import convert  # noqa: E402
from tests.torch_replay import (ReplayNoise, late_state, queue_collect,  # noqa: E402
                                queue_train)

CONFIG = "tuned_configs/mamujoco_jax/HalfCheetah-v2-6x1/hasac/config.json"
SEED = 1
DOF = 9           # the planar cheetah's degrees of freedom (its reset draws' width)
# One env step (5 physics substeps) from the same state, and the rows it
# inserts: float32 arithmetic ordered differently by XLA and by torch,
# amplified by the contacts; the replay test's data tolerance, which holds
# 4 free-running steps.
DATA_RTOL, DATA_ATOL = 1e-4, 2e-4
# One Adam step from the same parameters and moments: a step is about
# lr·m̂/√v̂, so a gradient's relative error e moves a parameter by ~lr·e
# (lr 1e-3); the replay test's parameter tolerance, which holds two steps.
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
# The float64 referee: the port's update and the JAX runner's, both in
# float64 from the same state and draws. Float64 rounding (~1e-16) moved by
# the same amplification as float32's (~1e-7) stays ~1e-9 of it.
REFEREE_RTOL, REFEREE_ATOL = 1e-6, 1e-9
SMALL = dict(n_rollout_threads=4, hidden_sizes=[16, 16], batch_size=16, buffer_size=4000,
             warmup_steps=400, episode_limit=60, train_interval=10)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


class Ledger:
    """The largest error of each quantity of one state, against its
    tolerance, with the worst element's place. An element beyond its
    tolerance in an update is refereed in float64: the same update from the
    same state and draws, by the port and by the JAX runner
    (``jax.enable_x64``), must agree (``REFEREE_*``), so that the port's
    arithmetic is the JAX runner's; and the port's float32 value must be no
    farther from the float64 one than the JAX runner's float32 value plus
    the element's tolerance, unless the port's float32 update took a
    decision other than its float64 update (``ties``: a ReLU, a log-std
    clamp or the twin critics' minimum that float32 rounding turned the
    other way for one sample), which moves the update by that sample's
    share whichever package rounds across."""

    def __init__(self):
        self.q, self.unit, self.exact_misses, self.ties = {}, None, [], []

    def hold(self, name: str, got, ref, rtol: float, atol: float, where: str = "",
             ref64=None) -> float:
        """Hold one tensor; returns its largest excess. ``ref64`` is the
        (port, JAX) float64 pair of the referee."""
        g = np.atleast_1d(np.asarray(torch.as_tensor(got).detach().cpu(), dtype=np.float64))
        r = np.atleast_1d(np.asarray(ref, dtype=np.float64))
        if g.shape != r.shape:
            raise ValueError(f"{name} {where}: shape {g.shape} against {r.shape}")
        err = np.abs(g - r)
        excess = err / (atol + rtol * np.abs(r))
        excess = np.where(np.isfinite(excess), excess, np.inf)
        rec = self.q.setdefault(name, dict(rtol=rtol, atol=atol, max_abs_err=0.0,
                                           max_excess=0.0, worst=None, held=0, beyond=0,
                                           refereed=0, farther=0, farther_untied=0,
                                           worst_refereed=None))
        rec["held"] += int(g.size)
        if not g.size:
            return 0.0
        i = np.unravel_index(int(np.argmax(excess)), excess.shape)
        rec["max_abs_err"] = max(rec["max_abs_err"], float(np.nan_to_num(err, nan=np.inf).max()))
        if excess[i] > rec["max_excess"] or rec["worst"] is None:
            rec["max_excess"] = max(rec["max_excess"], float(excess[i]))
            rec["worst"] = dict(unit=self.unit, tensor=where, index=[int(x) for x in i],
                                port=float(g[i]), jax=float(r[i]))
        beyond = excess > 1.0
        rec["beyond"] += int(beyond.sum())
        if ref64 is not None and beyond.any():
            p64 = np.atleast_1d(np.asarray(torch.as_tensor(ref64[0]).detach().cpu(),
                                           dtype=np.float64))
            j64 = np.atleast_1d(np.asarray(ref64[1], dtype=np.float64))
            same = np.abs(p64 - j64) <= REFEREE_ATOL + REFEREE_RTOL * np.abs(j64)
            port_off, jax_off = np.abs(g - j64), np.abs(r - j64)
            farther = beyond & (port_off > jax_off + atol + rtol * np.abs(j64))
            rec["refereed"] += int((beyond & same).sum())
            rec["farther"] += int(farther.sum())
            if not self.ties:
                rec["farther_untied"] += int(farther.sum())
            for k in zip(*np.nonzero(beyond)):
                w = rec["worst_refereed"]
                if w is None or excess[k] > w["excess"]:
                    rec["worst_refereed"] = dict(
                        unit=self.unit, tensor=where, index=[int(x) for x in k],
                        excess=float(excess[k]), port=float(g[k]), jax=float(r[k]),
                        port_float64=float(p64[k]), jax_float64=float(j64[k]),
                        float64_equal=bool(same[k]), port_from_float64=float(port_off[k]),
                        jax_from_float64=float(jax_off[k]), port_farther=bool(farther[k]),
                        ties_in_unit=len(self.ties))
        return float(excess[i])

    def merge(self, other: "Ledger") -> None:
        """Fold ``other``'s holds into this ledger."""
        self.exact_misses += other.exact_misses
        for k, v in other.q.items():
            rec = self.q.setdefault(k, v)
            if rec is v:
                continue
            for n in ("held", "beyond", "refereed", "farther", "farther_untied"):
                rec[n] += v[n]
            rec["max_abs_err"] = max(rec["max_abs_err"], v["max_abs_err"])
            if v["max_excess"] > rec["max_excess"]:
                rec["max_excess"], rec["worst"] = v["max_excess"], v["worst"]

    def exact(self, name: str, got, ref) -> None:
        if not np.array_equal(np.asarray(got), np.asarray(ref)):
            self.exact_misses.append(f"{name} at {self.unit}")

    def summary(self) -> dict:
        return dict(quantities=self.q, exact_misses=self.exact_misses,
                    ok=not self.exact_misses and all(
                        v["max_excess"] <= 1.0 or (v["beyond"] == v["refereed"]
                                                   and v["farther_untied"] == 0)
                        for v in self.q.values()))


@contextlib.contextmanager
def float32_draws():
    """While tracing a float64 JAX update: each normal drawn in float32 and
    then cast, each integer in int32, so its draws are the float32 run's."""
    normal, randint = jax.random.normal, jax.random.randint
    jax.random.normal = lambda key, shape=(), dtype=None: normal(
        key, shape, jnp.float32).astype(dtype or jnp.float64)
    jax.random.randint = lambda key, shape, minval, maxval, dtype=None: randint(
        key, shape, minval, maxval, jnp.int32)
    try:
        yield
    finally:
        jax.random.normal, jax.random.randint = normal, randint


def build(small: bool):
    """(args, algo_args, env_args) of ``CONFIG``, cut to test widths with
    ``small``."""
    args, algo_args, env_args = train.resolve_args(["--load_config", CONFIG])
    if small:
        algo_args["train"].update(n_rollout_threads=SMALL["n_rollout_threads"],
                                  warmup_steps=SMALL["warmup_steps"],
                                  train_interval=SMALL["train_interval"])
        algo_args["algo"].update(batch_size=SMALL["batch_size"],
                                 buffer_size=SMALL["buffer_size"])
        algo_args["model"]["hidden_sizes"] = SMALL["hidden_sizes"]
        env_args["episode_limit"] = SMALL["episode_limit"]
    return args, algo_args, env_args


def with_train(algo_args: dict, **train_keys) -> dict:
    out = copy.deepcopy(algo_args)
    out["train"].update(train_keys)
    return out


class Witness:
    def __init__(self, small: bool):
        self.args, self.algo_args, self.env_args = build(small)
        a, al, env = self.args, self.algo_args, self.env_args
        self.jr = JRunner(a, copy.deepcopy(al), copy.deepcopy(env))          # whole blocks
        unit = with_train(al, train_interval=1, update_per_train=1)
        self.j1 = JRunner(a, copy.deepcopy(unit), copy.deepcopy(env))        # one step, one update
        self.noise = ReplayNoise()
        self.t1 = OffPolicyRunner(a, copy.deepcopy(unit), copy.deepcopy(env), device="cpu",
                                  noise=self.noise)
        self.tb = OffPolicyRunner(a, copy.deepcopy(al), copy.deepcopy(env), device="cpu",
                                  noise=self.noise)
        self.B = self.jr.n_rollout_threads
        self.interval = self.jr.train_interval
        self.batch = self.jr.batch_size
        self.act_dims = [sp.shape[0] for sp in self.jr.act_spaces]
        self.ts = self.train64 = self.t64 = self.ts64 = None
        self.refereed = []          # the units held again with the float64 referee
        self.seconds = dict(jax=0.0, port=0.0, carry=0.0, referee=0.0)

    # ------------------------------------------------------------ carrying
    def carry_all(self, js) -> None:
        t0 = time.perf_counter()
        self.ts = convert.off_policy_state(self.t1, np_tree(js), self.ts)
        self.seconds["carry"] += time.perf_counter() - t0

    def carry_learners(self, js) -> None:
        t0 = time.perf_counter()
        convert.load_off_policy_actors(self.t1, self.ts, np_tree(js.actors))
        convert.load_off_policy_critic(self.t1, self.ts, np_tree(js.critic))
        self.ts.total_it = int(js.total_it)
        self.seconds["carry"] += time.perf_counter() - t0

    def carry_rows(self, js, start: int, n: int) -> None:
        """Rows [start, start + n) of the ring (mod its size), and its cursor."""
        t0 = time.perf_counter()
        S = self.ts.buffer.buffer_size
        ring = np_tree(js.buffer)
        first = min(n, S - start)
        convert.load_ring(self.ts.buffer, ring, slice(start, start + first))
        if first < n:
            convert.load_ring(self.ts.buffer, ring, slice(0, n - first))
        self.seconds["carry"] += time.perf_counter() - t0

    def carry_step(self, js) -> None:
        t0 = time.perf_counter()
        self.ts.carry = convert.off_policy_carry(np_tree(js.carry), self.ts.carry)
        self.ts.buffer.idx, self.ts.buffer.cur_size = int(js.buffer.idx), int(js.buffer.cur_size)
        self.seconds["carry"] += time.perf_counter() - t0

    # ------------------------------------------------------------ one unit
    def timed(self, side: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        if side == "jax":
            jax.block_until_ready(out)
        self.seconds[side] += time.perf_counter() - t0
        return out

    def collect_step(self, js, led: Ledger):
        queue_collect(self.noise, js.rng, 1, self.act_dims, self.B, DOF)
        self.carry_step(js)
        idx = int(js.buffer.idx)
        jn, jcm = self.timed("jax", self.j1._collect, js)
        self.ts, tcm = self.timed("port", self.t1.collect_block, self.ts)
        assert self.noise.drained()
        hold_inserted(led, self.ts.buffer, jn.buffer, idx, self.B)
        for k in ("episode_return_sum", "episode_count", "mean_step_reward"):
            led.hold(f"collect.{k}", tcm[k], jcm[k], DATA_RTOL, DATA_ATOL)
        c, jc = self.ts.carry, jn.carry
        for k in ("obs", "share_obs", "ep_ret", "agent_deaths"):
            led.hold(f"carry.{k}", getattr(c, k), getattr(jc, k), DATA_RTOL, DATA_ATOL)
        for k in ("q", "qd"):
            led.hold(f"carry.env_{k}", getattr(c.env_state, k), getattr(jc.env_state, k),
                     DATA_RTOL, DATA_ATOL)
        led.exact("carry.env_t", c.env_state.t, jc.env_state.t)
        return jn, float(jcm["episode_count"])

    def update(self, js, led: Ledger):
        """One update held; a unit beyond its tolerance is held again with
        the float64 referee (``Ledger``)."""
        cur = int(js.buffer.cur_size)
        queue_train(self.noise, self.j1, js.rng, 1, cur_size=cur, batch=self.batch,
                    total_it=int(js.total_it))
        starts = self.noise.starts[-1][1]
        self.carry_learners(js)
        jn, jtm = self.timed("jax", self.j1._train, js)
        self.ts, ttm = self.timed("port", self.t1.train_block, self.ts)
        assert self.noise.drained() and self.ts.total_it == int(jn.total_it)
        scratch = Ledger()
        scratch.unit = led.unit
        worst = max(hold_update(scratch, self.t1, self.ts, jn, ttm, jtm))
        if worst > 1.0:
            ref64, ties = self.referee(js, jtm, ttm)
            self.refereed.append(dict(unit=led.unit, ties=len(ties), closest_ties=sorted(
                ties, key=lambda t: t["float64_margin"])[:3]))
            led.ties = ties
            hold_update(led, self.t1, self.ts, jn, ttm, jtm, ref64)
            led.ties = []
        else:
            led.merge(scratch)
        head = int(js.buffer.idx)
        near = ((head - np.asarray(starts)) % max(cur, 1)) <= self.jr.n_step * self.B
        return jn, int(near.sum())

    def referee(self, js, jtm, ttm):
        """The update of ``js`` in float64 by the JAX runner (``jax.enable_x64``;
        its networks, optimizers and α cast, the ring's float32 data as they
        are, the same draws) and by the port (a runner built in float64, the
        same state carried in), and the port's float32 update again, the
        decisions of both port runs recorded (``decisions``). Returns ((port
        state, JAX state, port loss, JAX loss), the ties: each decision the
        float32 run took the other way); the JAX loss must be the float32
        run's to 1e-3, or the draws differ, and the float32 rerun must repeat
        the first bit for bit."""
        t0 = time.perf_counter()
        self.carry_learners(js)
        queue_train(self.noise, self.j1, js.rng, 1, cur_size=int(js.buffer.cur_size),
                    batch=self.batch, total_it=int(js.total_it))
        (self.ts, again), dec32 = decisions(self.ts, lambda: self.t1.train_block(self.ts))
        if float(again["critic_loss"]) != float(ttm["critic_loss"]):
            raise AssertionError("the port's float32 update did not repeat itself")
        with jax.enable_x64(True), float32_draws():
            if self.train64 is None:
                self.train64 = jax.jit(self.j1.train_block)
            cast = (lambda x: x.astype(jnp.float64)
                    if jnp.issubdtype(x.dtype, jnp.floating) else x)
            js64 = js._replace(actors=jax.tree.map(cast, js.actors),
                               critic=jax.tree.map(cast, js.critic))
            jn64, jtm64 = self.train64(js64)
            j64 = np_tree(jn64._replace(buffer=None, carry=None))
            jloss = float(jtm64["critic_loss"])
        loss32 = float(jtm["critic_loss"])
        if abs(jloss - loss32) > 1e-3 * abs(loss32):
            raise AssertionError(f"float64 referee: critic loss {jloss} against {loss32}")
        if self.t64 is None:
            prev = torch.get_default_dtype()
            torch.set_default_dtype(torch.float64)
            try:
                self.t64 = OffPolicyRunner(self.args, with_train(self.algo_args, train_interval=1,
                                                                 update_per_train=1),
                                           copy.deepcopy(self.env_args), device="cpu",
                                           noise=self.noise)
                self.ts64 = convert.off_policy_state(self.t64, np_tree(js))
            finally:
                torch.set_default_dtype(prev)
        else:
            convert.off_policy_state(self.t64, np_tree(js), self.ts64)
        queue_train(self.noise, self.j1, js.rng, 1, cur_size=int(js.buffer.cur_size),
                    batch=self.batch, total_it=int(js.total_it))
        (self.ts64, ttm64), dec64 = decisions(self.ts64,
                                              lambda: self.t64.train_block(self.ts64))
        assert self.noise.drained()
        self.seconds["referee"] += time.perf_counter() - t0
        return (self.ts64, j64, float(ttm64["critic_loss"]), jloss), ties(dec32, dec64)

    # ------------------------------------------------------------ a block
    def block(self, js, led: Ledger, label: str, whole: bool = False) -> tuple:
        """One collect block and one train block, unit by unit; with
        ``whole`` (or at the first), the whole state carried first."""
        if whole or self.ts is None:
            self.carry_all(js)
        else:
            self.carry_learners(js)
        start, ended = int(js.buffer.idx), 0.0
        for step in range(self.interval):
            led.unit = f"{label} collect step {step + 1}"
            js, n = self.collect_step(js, led)
            ended += n
        self.carry_rows(js, start, self.interval * self.B)
        straddle, self.refereed = 0, []
        for u in range(self.interval * self.jr.update_per_train):
            led.unit = f"{label} update {u + 1}"
            js, near = self.update(js, led)
            straddle += near
        return js, dict(episodes_ended=ended, starts_within_n_step_of_head=straddle,
                        refereed_units=self.refereed)

    def drift(self, js, label: str) -> dict:
        """The JAX runner's own collect and train blocks against the port's
        from the same state with replayed draws, with no resync."""
        self.ts = convert.off_policy_state(self.tb, np_tree(js), self.ts)
        led = Ledger()
        led.unit = f"{label} free collect block"
        queue_collect(self.noise, js.rng, self.interval, self.act_dims, self.B, DOF)
        idx = int(js.buffer.idx)
        jn, jcm = self.jr._collect(js)
        self.ts, tcm = self.tb.collect_block(self.ts)
        hold_inserted(led, self.ts.buffer, jn.buffer, idx, self.interval * self.B)
        for k in ("episode_return_sum", "episode_count", "mean_step_reward"):
            led.hold(f"collect.{k}", tcm[k], jcm[k], DATA_RTOL, DATA_ATOL)
        led.unit = f"{label} free train block"
        queue_train(self.noise, self.jr, jn.rng, self.interval * self.jr.update_per_train,
                    cur_size=int(jn.buffer.cur_size), batch=self.batch,
                    total_it=int(jn.total_it))
        jn2, jtm = self.jr._train(jn)
        self.ts, ttm = self.tb.train_block(self.ts)
        assert self.noise.drained()
        hold_update(led, self.tb, self.ts, jn2, ttm, jtm)
        out = led.summary()
        out.pop("ok")
        return dict(state=label, **out)


def decisions(ts, fn) -> tuple:
    """``fn()`` (an update of the port's state ``ts``) and the values its
    decisions turned on, in call order: each Linear of every actor's and the
    critic's networks and targets (a hidden layer's ReLU, a ``log_std``
    head's clamp) and each minimum of the twin critics, as (name, kind,
    values as float64)."""
    rec, hooks = [], []
    nets = [(f"actor {i} {w}", m) for i, a in enumerate(ts.actors)
            for w, m in (("net", a.net), ("target", a.target))]
    nets += [(f"critic {w} {j}", q) for w, qs in (("net", ts.critic.nets),
                                                  ("target", ts.critic.targets))
             for j, q in enumerate(qs)]
    for who, net in nets:
        linears = [(n, m) for n, m in net.named_modules() if isinstance(m, torch.nn.Linear)]
        # an actor's torso ends in a ReLU, a Q net in its scalar output
        last = linears[-1][0] if who.startswith("critic") else None
        for n, m in linears:
            kind = ("clamp" if n.endswith("log_std") else
                    None if n.endswith("mu") or n == last else "relu")
            if kind is not None:
                hooks.append(m.register_forward_hook(
                    lambda mod, i, o, name=f"{who} {n}", kind=kind:
                    rec.append((name, kind, o.detach().double().clone()))))
    min_q = ContinuousQCritic._min_q

    def recorded_min_q(nets, share_obs, joint_actions):     # ContinuousQCritic._min_q's
        qs = [net(share_obs, joint_actions) for net in nets]
        if len(qs) == 1:
            return qs[0]
        rec.append(("critic twin minimum", "min", (qs[0] - qs[1]).detach().double()))
        return torch.minimum(qs[0], qs[1])
    ContinuousQCritic._min_q = staticmethod(recorded_min_q)
    try:
        out = fn()
    finally:
        ContinuousQCritic._min_q = staticmethod(min_q)
        for h in hooks:
            h.remove()
    return out, rec


def ties(dec32: list, dec64: list) -> list:
    """The decisions the float32 update took the other way from the float64
    one: a ReLU's sign, a ``log_std`` clamp's side of each bound, the twin
    minimum's pick (the sign of Q1 − Q2); each with its float64 margin."""
    out = []
    for call, ((name, kind, v32), (name64, _, v64)) in enumerate(zip(dec32, dec64)):
        if name != name64 or v32.shape != v64.shape:
            raise AssertionError(f"call {call}: {name} against {name64}")
        bounds = (LOG_STD_MIN, LOG_STD_MAX) if kind == "clamp" else (0.0,)
        for b in bounds:
            for k in ((v32 > b) != (v64 > b)).nonzero().tolist():
                out.append(dict(kind=kind, call=call, where=name, index=k,
                                float32=float(v32[tuple(k)]), float64=float(v64[tuple(k)]),
                                float64_margin=abs(float(v64[tuple(k)]) - b)))
    if len(dec32) != len(dec64):
        raise AssertionError(f"{len(dec32)} decisions against {len(dec64)}")
    return out


def hold_inserted(led: Ledger, tb, jb, idx: int, n: int) -> None:
    rows = (idx + np.arange(n)) % tb.buffer_size
    led.exact("insert.cursor", (tb.idx, tb.cur_size), (int(jb.idx), int(jb.cur_size)))
    for k in ENV_LEVEL:
        led.hold(f"insert.{k}", getattr(tb, k)[rows], np.asarray(getattr(jb, k))[rows],
                 DATA_RTOL, DATA_ATOL)
    for k in PER_AGENT + AVAIL:
        if getattr(tb, k) is None:
            continue
        for i, (t, j) in enumerate(zip(getattr(tb, k), getattr(jb, k))):
            led.hold(f"insert.{k}", t[rows], np.asarray(j)[rows], DATA_RTOL, DATA_ATOL,
                     f"agent {i}")


def hold_update(led: Ledger, runner, ts, js, ttm, jtm, ref64=None) -> list:
    """The critic loss and every network, target, Adam moment and count,
    and α after an update; ``ref64`` is the float64 referee's (port state,
    JAX state, port loss, JAX loss). Returns the excesses held."""
    p64, j64 = (ref64[0], ref64[1]) if ref64 else (None, None)
    out = [led.hold("update.critic_loss", ttm["critic_loss"], jtm["critic_loss"], DATA_RTOL,
                    DATA_ATOL, ref64=ref64[2:] if ref64 else None)]
    actor_sd, critic_sd = convert.off_policy_converters(runner)
    sides = [(f"actor {i}", "actor", st, jst, actor_sd(i),
              None if p64 is None else (p64.actors[i], j64.actors[i]))
             for i, (st, jst) in enumerate(zip(ts.actors, js.actors))]
    sides.append(("critic", "critic", ts.critic, js.critic, critic_sd,
                  None if p64 is None else (p64.critic, j64.critic)))
    tol = (PARAM_RTOL, PARAM_ATOL)
    for who, kind, st, jst, to_sd, pair in sides:
        net, target = (st.net, st.target) if kind == "actor" else (st.nets, st.targets)
        ref, tref, mu, nu = _jax_side(jst, to_sd)
        refs64 = None if pair is None else (_port_side(pair[0], kind), _jax_side(pair[1], to_sd))
        two = (lambda n, k: None if refs64 is None
               else (refs64[0][n][k], refs64[1][n][k]))
        for k, p in net.named_parameters():
            out.append(led.hold(f"{kind}.params", p, ref[k], *tol, f"{who} {k}", two(0, k)))
            out.append(led.hold(f"{kind}.adam_mu", st.opt.state[p]["exp_avg"], mu[k], *tol,
                                f"{who} {k}", two(2, k)))
            out.append(led.hold(f"{kind}.adam_nu", st.opt.state[p]["exp_avg_sq"], nu[k], *tol,
                                f"{who} {k}", two(3, k)))
            led.exact(f"{kind}.adam_count {who} {k}", float(st.opt.state[p]["step"]),
                      float(jst.opt_state[0].count))
        for k, v in target.state_dict().items():
            out.append(led.hold(f"{kind}.targets", v, tref[k], *tol, f"{who} {k}", two(1, k)))
        if st.log_alpha is not None:
            a, ja = st.alpha_opt.state[st.log_alpha], jst.alpha_opt_state[0]
            if pair is not None:
                pa, pj = pair[0].alpha_opt.state[pair[0].log_alpha], pair[1].alpha_opt_state[0]
            out.append(led.hold(f"{kind}.log_alpha", st.log_alpha, jst.log_alpha, *tol, who,
                                None if pair is None else (pair[0].log_alpha,
                                                           pair[1].log_alpha)))
            out.append(led.hold(f"{kind}.alpha_adam_mu", a["exp_avg"], ja.mu, *tol, who,
                                None if pair is None else (pa["exp_avg"], pj.mu)))
            out.append(led.hold(f"{kind}.alpha_adam_nu", a["exp_avg_sq"], ja.nu, *tol, who,
                                None if pair is None else (pa["exp_avg_sq"], pj.nu)))
    return out


def _jax_side(jst, to_sd) -> tuple:
    """(params, targets, Adam mu, Adam nu) of a JAX actor or critic state,
    each a ``state_dict`` of the port's names, in the state's own float
    width (the converters make float32 tensors for the port)."""
    adam = jst.opt_state[0]
    wide = np.asarray(jax.tree.leaves(jst.params)[0]).dtype == np.float64
    with float64_convert(wide):
        return (to_sd(np_tree(jst.params)), to_sd(np_tree(jst.target_params)),
                to_sd(np_tree(adam.mu)), to_sd(np_tree(adam.nu)))


@contextlib.contextmanager
def float64_convert(on: bool = True):
    """While on: ``convert``'s arrays become float64 tensors, not float32."""
    narrow = convert._t
    if on:
        convert._t = lambda x: torch.from_numpy(np.array(x, dtype=np.float64, copy=True))
    try:
        yield
    finally:
        convert._t = narrow


def _port_side(st, kind: str) -> tuple:
    """The same four of a port actor or critic state."""
    net, target = (st.net, st.target) if kind == "actor" else (st.nets, st.targets)
    named = dict(net.named_parameters())
    return (named, target.state_dict(),
            {k: st.opt.state[p]["exp_avg"] for k, p in named.items()},
            {k: st.opt.state[p]["exp_avg_sq"] for k, p in named.items()})


def tiled_ring(js, rows: int, period: int):
    """``js`` with its ring's first ``rows`` rows the first ``period`` rows
    repeated whole in insertion order, and its cursor and size at ``rows``."""
    buf = js.buffer

    def tile(col):
        a = np.array(col)
        a[:rows] = a[np.arange(rows) % period]
        return jnp.asarray(a)

    fields = {}
    for k, v in buf._asdict().items():
        if k in ("idx", "cur_size"):
            fields[k] = jnp.asarray(rows % buf.share_obs.shape[0], jnp.int32) if k == "idx" \
                else jnp.asarray(rows, jnp.int32)
        elif v is None:
            fields[k] = None
        elif isinstance(v, tuple):
            fields[k] = tuple(tile(x) for x in v)
        else:
            fields[k] = tile(v)
    return js._replace(buffer=type(buf)(**fields))


def alphas_of(js) -> dict:
    return dict(actors=[float(np.exp(np.asarray(a.log_alpha))) for a in js.actors
                        if a.log_alpha is not None],
                critic=None if js.critic.log_alpha is None
                else float(np.exp(np.asarray(js.critic.log_alpha))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--blocks", type=int, default=12)
    p.add_argument("--late", default="410000:20000,810000:40000",
                   help="ring rows:Adam count, comma separated")
    p.add_argument("--log_alphas", default="0,-3,-6,-16")
    p.add_argument("--drift", action="store_true")
    p.add_argument("--small", action="store_true")
    p.add_argument("--out", default="validation_torch/hasac_witness.json")
    a = p.parse_args(argv)
    late = [tuple(int(x) for x in s.split(":")) for s in a.late.split(",") if s]
    log_alphas = [float(x) for x in a.log_alphas.split(",") if x]
    if a.small:
        late = [(r * SMALL["buffer_size"] // 1_000_000, c) for r, c in late]
    w = Witness(a.small)
    t_start = time.perf_counter()
    js = w.jr._warmup(w.jr.init_state(SEED))
    warm_rows = int(js.buffer.cur_size)
    print(f"warmup: {warm_rows} rows in {time.perf_counter() - t_start:.1f} s", flush=True)
    states, drift = [], []
    for b in range(1, a.blocks + 1):
        led = Ledger()
        t0 = time.perf_counter()
        label = f"(a) block {b}"
        if a.drift and b == a.blocks:
            drift.append(w.drift(js, label))
        js, info = w.block(js, led, label)
        rec = dict(state=label, ring_rows=int(js.buffer.cur_size), total_it=int(js.total_it),
                   alpha=alphas_of(js), seconds=time.perf_counter() - t0, **info, **led.summary())
        states.append(rec)
        print(f"{label}: ok {rec['ok']}, worst excess "
              f"{max(v['max_excess'] for v in rec['quantities'].values()):.3g}, "
              f"{info['episodes_ended']:.0f} episodes ended, {rec['seconds']:.1f} s", flush=True)
    base, period = js, int(js.buffer.cur_size)
    for rows, count in late:
        ring = tiled_ring(base, rows, period)
        for la in log_alphas:
            label = f"(b) ring {rows}, Adam count {count}, log alpha {la:g}"
            js = late_state(ring, count, la)
            if a.drift and rows == late[-1][0] and la == -6.0:
                drift.append(w.drift(js, label))
            led = Ledger()
            t0 = time.perf_counter()
            js, info = w.block(js, led, label, whole=True)
            rec = dict(state=label, ring_rows=int(js.buffer.cur_size),
                       total_it=int(js.total_it), alpha_after=alphas_of(js),
                       seconds=time.perf_counter() - t0, **info, **led.summary())
            states.append(rec)
            print(f"{label}: ok {rec['ok']}, worst excess "
                  f"{max(v['max_excess'] for v in rec['quantities'].values()):.3g}, "
                  f"{rec['seconds']:.1f} s", flush=True)
        del ring
    ok = all(s["ok"] for s in states)
    out = dict(
        script="scripts/torch_offpolicy_witness.py", config=CONFIG, small=a.small,
        seed=SEED, host=dict(platform=platform.platform(), cpus=os.cpu_count(),
                               torch=torch.__version__, jax=jax.__version__),
        widths=dict(n_rollout_threads=w.B, hidden_sizes=w.algo_args["model"]["hidden_sizes"],
                    batch_size=w.batch, n_step=w.jr.n_step, buffer_size=w.jr.buffer_size,
                    train_interval=w.interval,
                    episode_limit=w.env_args.get("episode_limit"), warmup_rows=warm_rows),
        tolerances=dict(
            data=dict(rtol=DATA_RTOL, atol=DATA_ATOL, holds="a collect step's inserted rows, "
                      "collect metrics, carry, and the critic loss",
                      why="one env step of float32 physics from the same state, ordered "
                          "differently by XLA and torch; the replay test's data tolerance"),
            params=dict(rtol=PARAM_RTOL, atol=PARAM_ATOL, holds="parameters, targets, Adam "
                        "moments and log alpha after one update",
                        why="one Adam step moves a parameter by ~lr times a gradient's "
                            "relative error; the replay test's parameter tolerance"),
            excess="max over elements of |port - jax| / (atol + rtol |jax|); at most 1 passes",
            referee=dict(rtol=REFEREE_RTOL, atol=REFEREE_ATOL,
                         rule="an update with an element beyond its tolerance runs again in "
                              "float64 in both packages, which must agree; the port's float32 "
                              "element must then be no farther from the float64 value than "
                              "JAX's float32 element plus the tolerance, unless the port's "
                              "float32 update turned a tie (a ReLU, a log-std clamp or the twin "
                              "minimum) the other way from its float64 update"),
            drift="no pass rule: whole blocks without a resync"),
        seconds=dict(total=time.perf_counter() - t_start, **w.seconds),
        ok=ok, states=states, drift=drift)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"{'all states within tolerance' if ok else 'MISMATCH'}; written to {a.out} "
          f"({out['seconds']['total']:.0f} s)", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
