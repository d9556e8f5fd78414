"""``scripts/torch_offpolicy_witness.py`` end to end at test widths
(``--small``): a block after the warmup and a late state, every unit held,
and with the parameter tolerance cut to nothing every update goes to the
float64 referee, where the port and the JAX runner must agree; and the
referee's rule and its ties on made-up values."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def _witness():
    spec = importlib.util.spec_from_file_location(
        "offpolicy_witness", ROOT / "scripts" / "torch_offpolicy_witness.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


w = _witness()


def test_the_witness_holds_a_block_and_a_late_state(tmp_path, monkeypatch):
    """At no parameter tolerance every element of every update is refereed:
    the two packages agree on all of them in float64, and the verdict is the
    rule's (a port value farther from float64 than JAX's passes only in a
    unit with a tie)."""
    monkeypatch.setattr(w, "PARAM_RTOL", 0.0)
    monkeypatch.setattr(w, "PARAM_ATOL", 1e-12)
    out = tmp_path / "witness.json"
    rc = w.main(["--small", "--blocks", "1", "--late", "410000:20000", "--log_alphas", "-16",
                 "--out", str(out)])
    d = json.loads(out.read_text())
    assert [s["state"] for s in d["states"]] == [
        "(a) block 1", "(b) ring 1640, Adam count 20000, log alpha -16"]
    for s in d["states"]:
        assert s["exact_misses"] == [] and len(s["refereed_units"]) == 10
        assert all(set(u) == {"unit", "ties", "closest_ties"} for u in s["refereed_units"])
        q = s["quantities"]
        assert q["actor.params"]["beyond"] > 0
        assert all(v["beyond"] == v["refereed"] for v in q.values())
        assert all(v["farther_untied"] <= v["farther"] <= v["beyond"] for v in q.values())
        assert s["ok"] == all(v["max_excess"] <= 1.0 or v["farther_untied"] == 0
                              for v in q.values())
        assert q["insert.dones"]["held"] == 10 * 4 and q["update.critic_loss"]["held"] == 10
    assert rc == (0 if d["ok"] else 1) and d["ok"] == all(s["ok"] for s in d["states"])
    assert d["states"][1]["ring_rows"] == 1640 + 10 * 4
    assert d["states"][1]["total_it"] == 20
    assert d["config"] == w.CONFIG and d["seed"] == w.SEED


@pytest.mark.parametrize("port,port64,ties,ok", [
    (1.0 + 1e-4, 1.0, [], True),           # beyond JAX's float32, nearer float64 than it
    (1.0 - 6e-4, 1.0, [], False),          # farther from float64 than JAX's, no tie
    (1.0 - 6e-4, 1.0, [{"kind": "min"}], True),     # the same, with a tie in the unit
    (1.0 + 1e-4, 1.0 + 1e-5, [], False),   # the float64 runs disagree
])
def test_the_referee_rule(port, port64, ties, ok):
    """JAX's float32 value 1 + 3e-4 against a float64 value of 1, at rtol
    1e-4 and atol 0: an element beyond its tolerance passes where the two
    float64 runs agree and the port is no farther from float64 than JAX
    plus the tolerance, or the port's float32 update broke a tie."""
    led = w.Ledger()
    led.unit, led.ties = "u", ties
    f64 = torch.float64
    led.hold("x", torch.tensor([port, 1.0], dtype=f64), np.array([1.0 + 3e-4, 1.0]), 1e-4, 0.0,
             "t", ref64=(torch.tensor([port64, 1.0], dtype=f64), np.array([1.0, 1.0])))
    rec, summary = led.q["x"], led.summary()
    assert rec["beyond"] == 1 and summary["ok"] is ok
    worst = rec["worst_refereed"]
    assert worst["port_from_float64"] == pytest.approx(abs(port - 1.0), rel=1e-4)
    assert worst["jax_from_float64"] == pytest.approx(3e-4, rel=1e-4)
    assert worst["ties_in_unit"] == len(ties)


def test_ties_are_the_decisions_rounding_turned():
    """A ReLU's sign, each side of the log-std clamp and the twin minimum's
    pick, each where the float32 run went the other way, with its float64
    margin; a different sequence of calls is an error."""
    f32 = [("a relu", "relu", torch.tensor([[0.5, -1e-7]])),
           ("a clamp", "clamp", torch.tensor([[-5.0 + 1e-6, 1.0, 2.0 + 1e-6]])),
           ("twins", "min", torch.tensor([[4e-7], [1.0]]))]
    f64 = [("a relu", "relu", torch.tensor([[0.5, 2e-8]], dtype=torch.float64)),
           ("a clamp", "clamp", torch.tensor([[-5.0 - 1e-7, 1.0, 2.0 - 3e-7]],
                                             dtype=torch.float64)),
           ("twins", "min", torch.tensor([[-5e-7], [1.0]], dtype=torch.float64))]
    got = w.ties(f32, f64)
    assert [(t["kind"], t["call"], t["index"]) for t in got] == [
        ("relu", 0, [0, 1]), ("clamp", 1, [0, 0]), ("clamp", 1, [0, 2]), ("min", 2, [0, 0])]
    assert [t["float64_margin"] for t in got] == pytest.approx([2e-8, 1e-7, 3e-7, 5e-7])
    with pytest.raises(AssertionError, match="call 1"):
        w.ties(f32, [f64[0], f64[2], f64[1]])
