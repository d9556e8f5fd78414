#!/usr/bin/env python3
"""Find the op of the port's planar physics whose rows depend on the
width of the batch they are computed in.

    python scripts/torch_planar_width.py [--device cuda|cpu] [--warm_steps 40]
        [--out FILE]

From seed 0: 256 HalfCheetah states, reset and then stepped
``--warm_steps`` env steps with random actions on the CPU (so that the
feet touch the ground), and a torque for each. The first 64 rows are
computed at the head of a batch of 64, 128 and 256 rows (the rows after them are
the other states) by the ``frame_skip`` substeps of one env step
(``PlanarDynamics.substep``, the torques in [-1, 1]) on ``--device``, with
every aten op they issue recorded, its inputs before it and its outputs
after (a ``TorchDispatchMode``), and its substep and the line of
``planar.py`` that issued it. Each op's tensors are held bitwise against the same op's at the
narrowest width: a tensor that carries the batch in a dimension is cut to
the 64 rows' part there (the batch outermost), one without the batch is
held whole. The op named is the first whose inputs agree and whose
output does not, with its first differing element, both values and the
widths; beside it the largest difference of q and qd after the first
substep and after the env step. It prints the JSON
record, with the card's name and power limit, and writes it to ``--out``.
Without a CUDA device, ``--device cuda`` exits non-zero.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
ROWS = 64
WIDTHS = (64, 128, 256)
SEED = 0


def states(seed: int, n: int, warm_steps: int):
    """(q, qd, tau) of ``n`` HalfCheetah envs on the CPU: reset from the
    seed's noise, ``warm_steps`` env steps of random actions, a torque each."""
    import torch

    from harl_tpu_torch.envs.mamujoco_jax import planar

    env = planar.make_planar({"scenario": "HalfCheetah-v2", "agent_conf": "6x1"},
                             torch.device("cpu"))
    rng = np.random.default_rng(seed)
    dof, nj = env.spec.dof, env.spec.n_joints
    noise = (torch.as_tensor(rng.random((n, dof), np.float32)),
             torch.as_tensor(rng.standard_normal((n, dof), np.float32)))
    st, _ = env.reset(noise)
    q, qd = st.q, st.qd
    for _ in range(warm_steps):
        act = torch.as_tensor(rng.uniform(-1, 1, (n, nj)).astype(np.float32))
        q, qd = env.dyn.physics_step(q, qd, act)
    tau = torch.as_tensor(rng.uniform(-1, 1, (n, nj)).astype(np.float32))
    return env.spec, q, qd, tau


def record_substeps(dyn, q, qd, tau, substeps: int):
    """[(op, "substep k, planar.py:line", inputs, outputs)] of ``substeps``
    substeps from (q, qd) under the torque ``tau``, the tensors copied to
    the host, and the last substep's (q, qd)."""
    import torch
    from torch.utils import _pytree as pytree
    from torch.utils._python_dispatch import TorchDispatchMode

    def host(tree):
        return [t.detach().clone().cpu() for t in pytree.tree_leaves(tree)
                if isinstance(t, torch.Tensor)]

    ops, k = [], 0

    class Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ins = host((args, kwargs))
            out = func(*args, **(kwargs or {}))
            line = next((f"planar.py:{f.lineno}" for f in reversed(traceback.extract_stack())
                         if f.filename.endswith("planar.py")), "?")
            ops.append((str(func), f"substep {k + 1}, {line}", ins, host(out)))
            return out

    with Recorder():
        for k in range(substeps):
            q, qd = dyn.substep(q, qd, tau)
    return ops, [q.cpu(), qd.cpu()]


def rows_of(t, ref, width: int):
    """``t`` (from a batch of ``width``) cut to the part ``ref`` (from the
    narrowest batch) holds: the first dimension whose size is ref's times
    width / ROWS is cut to ref's size; None where no dimension is."""
    if t.shape == ref.shape:
        return t
    k = width // ROWS
    for d in range(t.dim()):
        if (t.shape[d] == ref.shape[d] * k and t.shape[:d] == ref.shape[:d]
                and t.shape[d + 1:] == ref.shape[d + 1:]):
            return t.narrow(d, 0, ref.shape[d])
    return None


def same(t, ref, width: int):
    """True, False, or None where the two cannot be lined up."""
    import torch

    cut = rows_of(t, ref, width)
    return None if cut is None else bool(torch.equal(cut, ref))


def first_difference(t, ref, width: int) -> dict:
    cut = rows_of(t, ref, width)
    diff = (cut.double() - ref.double()).abs()
    idx = tuple(int(i) for i in np.unravel_index(int(diff.argmax()), tuple(diff.shape)))
    first = tuple(int(i) for i in (cut != ref).nonzero()[0])
    return dict(shape=list(ref.shape), first_index=list(first),
                first_value_narrow=float(ref[first]), first_value_wide=float(cut[first]),
                elements_differing=int((cut != ref).sum()), elements=ref.numel(),
                max_abs=float(diff.max()), max_abs_index=list(idx))


def compare(narrow, wide, width: int) -> dict:
    """The first op whose output's rows differ, and the first whose inputs
    agree (or do not line up) while its output differs: the origin."""
    if [o[0] for o in narrow] != [o[0] for o in wide]:
        return dict(error="the widths issued different ops")
    first = origin = None
    for i, ((name, line, ins0, outs0), (_, _, ins1, outs1)) in enumerate(zip(narrow, wide)):
        outs = [same(b, a, width) for a, b in zip(outs0, outs1)]
        if False not in outs:
            continue
        j = outs.index(False)
        entry = dict(op_index=i, op=name, line=line, output=j,
                     **first_difference(outs1[j], outs0[j], width))
        first = first or entry
        if False not in [same(b, a, width) for a, b in zip(ins0, ins1)]:
            origin = entry
            break
    return dict(ops=len(narrow), first_differing_output=first, origin=origin)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--warm_steps", type=int, default=40)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import torch

    from harl_tpu_torch.envs.mamujoco_jax import planar

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (or --device cpu)", file=sys.stderr)
        return 1
    card = "cpu"
    if args.device == "cuda":
        spec = importlib.util.spec_from_file_location("chip_smoke_width", REPO / "chip_smoke.py")
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        card = smoke.card_line()
    spec, q, qd, tau = states(SEED, max(WIDTHS), args.warm_steps)
    dev = torch.device(args.device)
    dyn = planar.PlanarDynamics(spec, dev)
    runs = {}
    for w in WIDTHS:
        x = [t[:w].to(dev) for t in (q, qd, tau)]
        ops, out = record_substeps(dyn, *x, spec.frame_skip)
        first = dyn.substep(*x)
        runs[w] = dict(ops=ops, substep=[t[:ROWS].cpu() for t in first],
                       step=[t[:ROWS] for t in out])
    base = runs[ROWS]
    contacts = int((dyn.crad.cpu() - dyn.kin_analytic(q[:ROWS].to(dev), qd[:ROWS].to(dev))[2]
                    [:, :, 1].cpu() > 0).sum())
    result = dict(card=card, device=args.device, seed=SEED, warm_steps=args.warm_steps,
                  rows=ROWS, widths=WIDTHS, active_contacts_of_the_rows=contacts,
                  by_width={})
    for w in WIDTHS[1:]:
        r = runs[w]
        result["by_width"][str(w)] = dict(
            against=ROWS, **compare(base["ops"], r["ops"], w),
            substep_max_abs=dict(q=float((r["substep"][0] - base["substep"][0]).abs().max()),
                                 qd=float((r["substep"][1] - base["substep"][1]).abs().max())),
            step_max_abs=dict(q=float((r["step"][0] - base["step"][0]).abs().max()),
                              qd=float((r["step"][1] - base["step"][1]).abs().max())))
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
