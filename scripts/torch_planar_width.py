#!/usr/bin/env python3
"""Find every op of the port's batched envs whose rows depend on the width
of the batch they are computed in.

    python scripts/torch_planar_width.py [--env NAMES] [--device cuda|cpu]
        [--widths 10,16,20,64,256,512,1024,2048,4096] [--warm_steps 40] [--out FILE]

``--env`` is a comma-separated list of the names in ``SCENARIOS`` (every
MAMuJoCo-JAX scenario the port builds, with the tuned configs' env_args
where there are some) and ``OTHERS`` (the other pure-tensor envs), or
``mamujoco`` (the default), ``others`` or ``all``.

For each env, from seed 0 on ``--device``: the widest batch is reset and
stepped ``--warm_steps`` env steps with random actions (so that feet touch
the ground and episodes end), all draws made with numpy, and ordered
busiest first (``busiest_first``: the envs whose checked step computes the
most nonzero values, so that the sums' terms are many). Then the head rows
(the narrowest width, 10) are stepped once more at the head of a batch of
each width, the rows after them the other envs: one whole
``auto_reset_step`` (the physics, reward, termination, the reset and the
observations with their per-row standardisation) from the same state,
actions and reset draws. Every aten op of the step is seen by a
``TorchDispatchMode``, with the line of the env module that issued it.

The narrowest run records each op's outputs. At a wider width each op's
output is cut to the head rows (the dimension that carries the batch, the
batch outermost in it; ``blocks`` = 2 where an env stacks two halves of
the batch, as coupled_half_cheetah stacks its cheetahs) and held bitwise
against the narrow run's; where it differs the op is listed and the head
rows of its output are overwritten with the narrow run's, so that every
later op again sees the same inputs and every op that differs is listed,
not only the first. An op whose output has no batch dimension while its
inputs have one reduces across the batch and is listed apart
(``across_batch``). Beside the list, a plain step at each width (no mode)
gives the largest difference of the head rows of every output.

It prints the JSON record, with the card's name and power limit, and writes
it to ``--out``. Without a CUDA device, ``--device cuda`` exits non-zero.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
ROWS = 10
# the tuned configs' 10, 20 and 1,024 envs, chip_smoke.py's 16 (off-policy),
# 512 (use_gae: false) and 2,048 (a data-parallel rank), the bench's 4,096
WIDTHS = (10, 16, 20, 64, 256, 512, 1024, 2048, 4096)
SEED = 0
ENVS_DIR = str(REPO / "harl_tpu_torch" / "envs")

# name: (env, env_args, blocks)
SCENARIOS = {
    "HalfCheetah-6x1": ("mamujoco_jax", {"scenario": "HalfCheetah-v2", "agent_conf": "6x1"}, 1),
    "Walker2d-2x3": ("mamujoco_jax", {"scenario": "Walker2d-v2", "agent_conf": "2x3"}, 1),
    "Hopper-3x1": ("mamujoco_jax", {"scenario": "Hopper-v2", "agent_conf": "3x1"}, 1),
    "coupled_half_cheetah": ("mamujoco_jax", {"scenario": "coupled_half_cheetah",
                                              "agent_conf": "1p1"}, 2),
    "Ant-4x2": ("mamujoco_jax", {"scenario": "Ant-v2", "agent_conf": "4x2"}, 1),
    "manyagent_ant": ("mamujoco_jax", {"scenario": "manyagent_ant", "agent_conf": "2x3"}, 1),
    "Humanoid-17x1": ("mamujoco_jax", {"scenario": "Humanoid-v2", "agent_conf": "17x1",
                                       "obs_standardize": False}, 1),
    "HumanoidStandup-17x1": ("mamujoco_jax", {"scenario": "HumanoidStandup-v2",
                                              "agent_conf": "17x1"}, 1),
    "manyagent_swimmer": ("mamujoco_jax", {"scenario": "manyagent_swimmer",
                                           "agent_conf": "10x2"}, 1),
    "Reacher-2x1": ("mamujoco_jax", {"scenario": "Reacher-v2", "agent_conf": "2x1"}, 1),
}
OTHERS = {
    "smaclite-5m_vs_6m": ("smaclite", {"map_name": "5m_vs_6m"}, 1),
    "smacv2-protoss_5_vs_5": ("smacv2", {"map_name": "protoss_5_vs_5", "backend": "jax"}, 1),
    "mpe-simple_spread": ("pettingzoo_mpe", {"scenario": "simple_spread_v2",
                                             "continuous_actions": True}, 1),
    "soccer-3_vs_1_with_keeper": ("football_jax", {"env_name": "academy_3_vs_1_with_keeper",
                                                   "rewards": "scoring,checkpoints",
                                                   "episode_limit": 400}, 1),
    "aircombat-2v2": ("lag_jax", {"scenario": "2v2", "episode_limit": 300,
                                  "enemy_skill": 0.5}, 1),
    "dexhands-ShadowHandOver": ("dexhands_jax", {"task": "ShadowHandOver"}, 1),
    "dexhands-ShadowHandDoorOpenOutward": ("dexhands_jax",
                                           {"task": "ShadowHandDoorOpenOutward"}, 1),
}
GROUPS = {"mamujoco": list(SCENARIOS), "others": list(OTHERS),
          "all": list(SCENARIOS) + list(OTHERS)}


# ------------------------------------------------------------ the inputs
def draws(rng, spec, n: int):
    """An env's reset draws (``reset_noise_spec``) for ``n`` envs, numpy."""
    out = []
    for kind, width, *high in spec:
        if kind == "uniform":
            out.append(rng.random((n, width), np.float32))
        elif kind == "normal":
            out.append(rng.standard_normal((n, width), np.float32))
        else:
            out.append(rng.integers(0, high[0], (n, width)).astype(np.int64))
    return out


def actions(rng, env, n: int, available=None):
    """(n, agents, width) float32 random actions: uniform in a Box, an
    available index (uniform among them) for Discrete, one index a part for
    MultiDiscrete."""
    from harl_tpu_torch.utils import spaces

    sp = env.action_space
    width = max(s.dim if isinstance(s, spaces.Box) else len(s.nvec)
                if isinstance(s, spaces.MultiDiscrete) else 1 for s in sp)
    a = np.zeros((n, len(sp), width), np.float32)
    for i, s in enumerate(sp):
        if isinstance(s, spaces.Box):
            lo, hi = np.asarray(s.low, np.float32), np.asarray(s.high, np.float32)
            a[:, i, :s.dim] = lo + (hi - lo) * rng.random((n, s.dim), np.float32)
        elif isinstance(s, spaces.Discrete):
            avail = np.ones((n, s.n)) if available is None else available[:, i, :s.n]
            a[:, i, 0] = np.argmax(rng.random((n, s.n)) * avail + avail, axis=1)
        else:
            for k, m in enumerate(s.nvec):
                a[:, i, k] = rng.integers(0, m, n)
    return a


def warm_inputs(name: str, device, width: int, warm_steps: int, seed: int = SEED):
    """The env (on ``device``) and, for ``width`` envs on the CPU, the state
    after the warm steps, the actions and the reset draws of the checked step."""
    import torch
    from torch.utils._pytree import tree_map_only

    from harl_tpu_torch.envs import make_env
    from harl_tpu_torch.envs.core import auto_reset_step

    env_name, env_args, _ = {**SCENARIOS, **OTHERS}[name]
    env = make_env(env_name, dict(env_args), device)
    rng = np.random.default_rng(seed)
    dev = lambda x: torch.as_tensor(x, device=device)
    state, ts = env.reset([dev(x) for x in draws(rng, env.reset_noise_spec, width)])
    avail = lambda t: None if t.available_actions is None else t.available_actions.cpu().numpy()
    for _ in range(warm_steps):
        a = dev(actions(rng, env, width, avail(ts)))
        tr = auto_reset_step(env, state, a, [dev(x) for x in draws(rng, env.reset_noise_spec,
                                                                      width)])
        state, ts = tr.state, tr.ts
    a = dev(actions(rng, env, width, avail(ts)))
    noise = [dev(x) for x in draws(rng, env.reset_noise_spec, width)]
    order = busiest_first(env, state, a, noise)
    cut = lambda t: t[order].cpu() if t.dim() and t.shape[0] == width else t.cpu()
    return env, tree_map_only(torch.Tensor, cut, state), cut(a), [cut(x) for x in noise]


def busiest_first(env, state, a, noise):
    """The envs' order by how many nonzero values the checked step computes
    for each (summed over every op's output that has the batch first),
    busiest first, ties in batch order. A sum's terms round differently in
    another order only where several are nonzero: the head rows are then
    the envs with the most contacts, limits and forces at work."""
    import torch
    from torch.utils import _pytree as pytree
    from torch.utils._python_dispatch import TorchDispatchMode

    from harl_tpu_torch.envs.core import auto_reset_step

    width = a.shape[0]
    busy = torch.zeros(width, dtype=torch.long, device=a.device)

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in pytree.tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.dim() and t.shape[0] == width:
                    busy.add_((t.detach() != 0).reshape(width, -1).sum(1))
            return out

    with Count():
        auto_reset_step(env, state, a, noise)
    return torch.sort(-busy, stable=True).indices


# --------------------------------------------------------- the recording
def _where():
    """(line, stack) of the env modules' frames that issued the current op:
    the innermost as ``file.py:line``, and the whole chain outermost first."""
    frame, chain = sys._getframe(2), []
    while frame is not None:
        code = frame.f_code
        if code.co_filename.startswith(ENVS_DIR):
            chain.append(f"{Path(code.co_filename).name}:{frame.f_lineno} {code.co_name}")
        frame = frame.f_back
    line = next((c.split(" ")[0] for c in chain if not c.startswith("fixed_sum.py")), "?")
    return line, " < ".join(chain)


def _rows(t, ref, width: int, blocks: int):
    """The index of ``t``'s head rows: (dim, [(start, length), ...]) where a
    dimension of ``t`` (from a batch of ``width``) is ``ref``'s (from a batch
    of ROWS) times width / ROWS and the others equal; "same" where the shapes
    are equal; None where nothing lines up."""
    if tuple(t.shape) == tuple(ref.shape):
        return "same"
    for d in range(t.dim()):
        if (t.dim() == ref.dim() and t.shape[d] * ROWS == ref.shape[d] * width
                and t.shape[:d] == ref.shape[:d] and t.shape[d + 1:] == ref.shape[d + 1:]):
            n = ref.shape[d]
            if blocks > 1 and n % (blocks * ROWS) == 0:
                k = n // blocks
                return d, [(b * k * width // ROWS, k) for b in range(blocks)]
            return d, [(0, n)]
    return None


def _cut(t, rows):
    import torch

    d, segs = rows
    parts = [t.narrow(d, s, n) for s, n in segs]
    return parts[0] if len(parts) == 1 else torch.cat(parts, d)


def _difference(cut, ref) -> dict:
    a, b = cut.cpu(), ref
    if a.dtype.is_floating_point:
        diff = (a.double() - b.double()).abs()
        diff = diff.nan_to_num(nan=float("inf"))
    else:
        diff = (a.long() - b.long()).abs().double()
    apart = a != b
    if a.dtype.is_floating_point:
        apart = apart & ~(a.isnan() & b.isnan())
    first = tuple(int(i) for i in apart.nonzero()[0])
    return dict(shape=list(ref.shape), first_index=list(first),
                value_narrow=float(b[first]), value_wide=float(a[first]),
                elements_differing=int(apart.sum()), elements=ref.numel(),
                max_abs=float(diff.max()))


def same_bits(a, b) -> bool:
    import torch

    return bool(torch.equal(a, b)) or (a.dtype.is_floating_point and bool(
        ((a == b) | (a.isnan() & b.isnan())).all()))


def recorder(narrow=None, width: int = ROWS, blocks: int = 1):
    """A TorchDispatchMode that records each op's name, line and outputs
    (``narrow`` None) or holds each against ``narrow``'s record, lists the
    ops apart and pins their head rows to the narrow run's."""
    import torch
    from torch.utils import _pytree as pytree
    from torch.utils._python_dispatch import TorchDispatchMode

    def leaves(tree):
        return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]

    class Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops, self.apart, self.across, self.unaligned, self.error = [], [], [], [], None

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if self.error is not None:
                return out
            ins, outs = leaves((args, kwargs)), leaves(out)
            i = len(self.ops)
            line, stack = _where()
            if narrow is None:
                self.ops.append((str(func), line, [tuple(t.shape) for t in ins],
                                 [t.detach().cpu().clone() for t in outs]))
                return out
            self.ops.append(str(func))
            if i >= len(narrow) or narrow[i][0] != str(func):
                self.error = f"op {i}: {func} where the narrow run issued " + (
                    narrow[i][0] if i < len(narrow) else "nothing")
                return out
            _, _, in_shapes, refs = narrow[i]
            batched = [tuple(t.shape) for t in ins] != in_shapes
            for j, (t, ref) in enumerate(zip(outs, refs)):
                rows = _rows(t, ref, width, blocks)
                if rows == "same" and batched:
                    self.across.append(dict(op_index=i, op=str(func), line=line))
                    continue
                if rows is None:
                    self.unaligned.append(dict(op_index=i, op=str(func), line=line,
                                               shape=list(t.shape), narrow=list(ref.shape)))
                    continue
                cut = t.detach() if rows == "same" else _cut(t.detach(), rows)
                if same_bits(cut.cpu(), ref):
                    continue
                self.apart.append(dict(op_index=i, op=str(func), line=line, stack=stack,
                                       output=j, **_difference(cut, ref)))
                with torch.no_grad():
                    if rows == "same":
                        t.copy_(ref)
                    else:
                        d, segs = rows
                        at = 0
                        for s, n in segs:
                            t.narrow(d, s, n).copy_(ref.narrow(d, at, n))
                            at += n
            return out

    return Recorder()


def _group(apart: list, seed: int) -> list:
    """The ops apart grouped by (op, line), in the order first seen: the
    count, the seed and the first occurrence."""
    groups = {}
    for e in apart:
        g = groups.setdefault((e["op"], e["line"]), dict(op=e["op"], line=e["line"],
                                                          occurrences=0, seeds=[seed],
                                                          first=e))
        g["occurrences"] += 1
    return list(groups.values())


def inputs_at(inputs, width: int, device):
    """(state, actions, reset draws) of the first ``width`` envs of
    ``warm_inputs``' CPU tensors, on ``device``."""
    import torch
    from torch.utils._pytree import tree_map_only

    state, act, noise = inputs
    on = lambda t: t[:width].to(device).clone() if t.dim() and t.shape[0] > width else t.to(device)
    return tree_map_only(torch.Tensor, on, state), on(act), [on(x) for x in noise]


def step_rows(env, inputs, width: int, device) -> list:
    """The head rows of every output of one plain ``auto_reset_step`` of the
    first ``width`` envs, on the CPU, as a flat list."""
    import torch

    from harl_tpu_torch.envs.core import auto_reset_step

    tr = auto_reset_step(env, *inputs_at(inputs, width, device))
    cut = lambda t: t[:ROWS].cpu() if t.dim() and t.shape[0] == width else t.cpu()
    return [cut(t) for t in torch.utils._pytree.tree_leaves(tr) if isinstance(t, torch.Tensor)]


def check_env(name: str, device, widths=WIDTHS, warm_steps: int = 40, seed: int = SEED) -> dict:
    """The record of one env from one seed: per width the ops apart, the ops
    across the batch and the largest difference of each output's head rows."""
    import torch

    from harl_tpu_torch.envs.core import auto_reset_step

    blocks = {**SCENARIOS, **OTHERS}[name][2]
    env, *inputs = warm_inputs(name, device, max(widths), warm_steps, seed)
    narrow_mode, args = recorder(), inputs_at(inputs, ROWS, device)
    with narrow_mode:
        auto_reset_step(env, *args)
    narrow = narrow_mode.ops
    base = step_rows(env, inputs, ROWS, device)
    rec = dict(ops=len(narrow), by_width={})
    for w in widths:
        if w == ROWS:
            continue
        mode, args = recorder(narrow, w, blocks), inputs_at(inputs, w, device)
        with mode:
            auto_reset_step(env, *args)
        outs = step_rows(env, inputs, w, device)
        diffs = [float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
                 for a, b in zip(outs, base) if a.dtype.is_floating_point]
        rec["by_width"][str(w)] = dict(
            error=mode.error, ops_apart=len(mode.apart), apart=_group(mode.apart, seed),
            across_batch=_group(mode.across, seed), unaligned=mode.unaligned[:20],
            step_rows_equal=all(same_bits(a, b) for a, b in zip(outs, base)),
            step_max_abs=max(diffs, default=0.0))
    if device.type == "cuda":
        torch.cuda.synchronize()
    return rec


def merge_seeds(recs: dict) -> dict:
    """One env's records from several seeds as one: per width the ops apart
    of every seed (a group's occurrences summed, the seeds it showed in),
    and the worst of the step's differences."""
    first = next(iter(recs.values()))
    out = dict(ops=first["ops"], seeds=[int(s) for s in recs], by_width={})
    for w in first["by_width"]:
        rs = [r["by_width"][w] for r in recs.values()]
        merged = {}
        for key in ("apart", "across_batch"):
            groups = {}
            for r in rs:
                for g in r[key]:
                    have = groups.get((g["op"], g["line"]))
                    if have is None:
                        groups[(g["op"], g["line"])] = dict(g)
                    else:
                        have["occurrences"] += g["occurrences"]
                        have["seeds"] = have["seeds"] + g["seeds"]
            merged[key] = list(groups.values())
        out["by_width"][w] = dict(
            error=next((r["error"] for r in rs if r["error"]), None),
            ops_apart=sum(r["ops_apart"] for r in rs), **merged,
            unaligned=[u for r in rs for u in r["unaligned"]][:20],
            step_rows_equal=all(r["step_rows_equal"] for r in rs),
            step_max_abs=max(r["step_max_abs"] for r in rs))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--env", default="mamujoco")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--widths", default=",".join(map(str, WIDTHS)))
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--warm_steps", type=int, default=40)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (or --device cpu)", file=sys.stderr)
        return 1
    names = [n for part in args.env.split(",") for n in GROUPS.get(part, [part])]
    unknown = [n for n in names if n not in SCENARIOS and n not in OTHERS]
    if unknown:
        print(f"unknown --env {unknown}; choose from {GROUPS['all']} or {list(GROUPS)}",
              file=sys.stderr)
        return 2
    widths = tuple(int(w) for w in args.widths.split(","))
    seeds = [int(s) for s in args.seeds.split(",")]
    if widths[0] != ROWS:
        print(f"the narrowest width must be {ROWS}", file=sys.stderr)
        return 2
    card = "cpu"
    if args.device == "cuda":
        spec = importlib.util.spec_from_file_location("chip_smoke_width", REPO / "chip_smoke.py")
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        card = smoke.card_line()
    device = torch.device(args.device)
    result = dict(card=card, device=args.device, torch=torch.__version__, root=str(REPO),
                  seeds=seeds, warm_steps=args.warm_steps, rows=ROWS, widths=list(widths),
                  envs={})
    for name in names:
        result["envs"][name] = merge_seeds({s: check_env(name, device, widths, args.warm_steps, s)
                                            for s in seeds})
        by = result["envs"][name]["by_width"].values()
        print(f"{name}: {result['envs'][name]['ops']} ops a step; ops apart by width "
              + ", ".join(f"{w}: {r['ops_apart']}" for w, r in
                          zip(widths[1:], by)), file=sys.stderr, flush=True)
    result["ops_apart"] = sum(r["ops_apart"] + bool(r["error"]) for e in result["envs"].values()
                              for r in e["by_width"].values())
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
