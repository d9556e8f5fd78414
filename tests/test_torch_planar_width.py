"""``scripts/torch_planar_width.py`` on the CPU: one whole env step of
HalfCheetah, the Ant and the Humanoid agrees row for row at batch widths 10,
20 and 64; a width-dependent op planted in the planar physics or in the Ant
is the op the script names, with its line; and ``fixed_sum``, the sum the
physics contracts with, equals ``torch.sum`` in float64 and adds in the
tree its docstring gives."""
import importlib.util
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from harl_tpu_torch.envs.mamujoco_jax import planar
from harl_tpu_torch.envs.mamujoco_jax.fixed_sum import fixed_sum

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "torch_planar_width.py"
_spec = importlib.util.spec_from_file_location("torch_planar_width", SCRIPT)
width = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(width)

CHECKED = ("HalfCheetah-6x1", "Ant-4x2", "Humanoid-17x1")


def _run(tmp_path, name, envs, widths="10,20,64"):
    out = tmp_path / name
    assert width.main(["--device", "cpu", "--env", envs, "--widths", widths, "--seeds", "0",
                       "--warm_steps", "2", "--out", str(out)]) == 0
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("width"), "clean.json", ",".join(CHECKED))


@pytest.mark.parametrize("name", CHECKED)
def test_the_check_finds_no_op_apart(clean, name):
    assert clean["card"] == "cpu" and clean["widths"] == [10, 20, 64] and clean["rows"] == 10
    rec = clean["envs"][name]
    assert rec["ops"] > 1000                     # the whole auto_reset_step is seen
    for w in ("20", "64"):
        r = rec["by_width"][w]
        assert r["error"] is None and r["unaligned"] == []
        assert r["ops_apart"] == 0 and r["apart"] == []
        assert r["step_rows_equal"] and r["step_max_abs"] == 0.0
    assert clean["ops_apart"] == 0


def _source_line(module, line: str) -> str:
    file, no = line.split(":")
    assert file == Path(module.__file__).name
    return Path(module.__file__).read_text().splitlines()[int(no) - 1]


def test_the_script_names_a_planted_width_dependent_op(tmp_path, monkeypatch):
    """The solve's right-hand side scaled by 1 + 1e-6 from 20 rows up: the
    one op named is that product, at the line that calls the solve, in
    every substep."""
    solve = planar.gauss_solve
    monkeypatch.setattr(planar, "gauss_solve",
                        lambda A, b: solve(A, b * (1.0 + 1e-6 * (b.shape[0] // 20))))
    rec = _run(tmp_path, "planted.json", "HalfCheetah-6x1")["envs"]["HalfCheetah-6x1"]
    for w in ("20", "64"):
        r = rec["by_width"][w]
        assert r["ops_apart"] == planar.HALF_CHEETAH.frame_skip
        (group,) = r["apart"]
        assert group["op"] == "aten.mul.Tensor" and group["occurrences"] == 5
        assert "gauss_solve(" in _source_line(planar, group["line"])
        first = group["first"]
        assert first["shape"] == [10, 9] and first["value_narrow"] != first["value_wide"]
        assert "physics_step < planar.py" in first["stack"]
        assert not r["step_rows_equal"] and r["step_max_abs"] > 0


def test_the_script_names_a_width_dependent_op_planted_in_the_ant(tmp_path, monkeypatch):
    """The Ant's float64 solve fed a right-hand side scaled by 1 + 1e-9 from
    20 rows up: that product is named at ant.py's solve, and nothing else."""
    from harl_tpu_torch.envs.mamujoco_jax import ant

    solve = torch.linalg.solve_ex
    monkeypatch.setattr(torch.linalg, "solve_ex",
                        lambda A, b: solve(A, b * (1.0 + 1e-9 * (b.shape[0] // 20))))
    rec = _run(tmp_path, "ant.json", "Ant-4x2", "10,20")["envs"]["Ant-4x2"]
    r = rec["by_width"]["20"]
    (group,) = r["apart"]
    assert group["op"] == "aten.mul.Tensor" and group["occurrences"] == ant.FRAME_SKIP
    assert "solve_ex(" in _source_line(ant, group["line"])
    assert group["first"]["shape"] == [10, 14]
    assert not r["step_rows_equal"]


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 24, 31, 100])
@pytest.mark.parametrize("dim", [0, 1, -1])
def test_fixed_sum_equals_torch_sum_in_float64(n, dim):
    shape = [4, 3, 5]
    shape[dim] = n
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(shape))
    got = fixed_sum(x, dim)
    assert got.shape == x.sum(dim).shape
    torch.testing.assert_close(got, x.sum(dim), rtol=1e-13, atol=1e-13)


def test_fixed_sum_adds_in_its_tree():
    """24 terms: 12 + 12, 6 + 6, 3 + 3, then two adds; 3 terms: the first
    plus the last, then the middle. float32, where another order rounds
    otherwise."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((24, 7)) * 10.0 ** rng.uniform(-4, 4, (24, 7)))
                         .astype(np.float32))
    h = x[:12] + x[12:]
    h = h[:6] + h[6:]
    h = h[:3] + h[3:]
    assert torch.equal(fixed_sum(x, 0), (h[0] + h[2]) + h[1])
    assert torch.equal(fixed_sum(x[:3], 0), (x[0] + x[2]) + x[1])
    assert torch.equal(fixed_sum(x[:1], 0), x[0])
    assert torch.equal(fixed_sum(x[:0], 0), torch.zeros(7))


def test_the_script_imports_without_jax():
    """The script, and the physics it records, with JAX, flax, optax and
    harl_tpu made unimportable."""
    code = textwrap.dedent("""
        import importlib.util, sys
        import torch
        for name in ("jax", "jaxlib", "flax", "optax", "harl_tpu"):
            sys.modules[name] = None
        spec = importlib.util.spec_from_file_location("width", "scripts/torch_planar_width.py")
        width = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(width)
        from harl_tpu_torch.envs import make_env
        for env_name, env_args, _ in list(width.SCENARIOS.values()) + list(width.OTHERS.values()):
            make_env(env_name, env_args, "cpu")
        env, state, a, noise = width.warm_inputs("HalfCheetah-6x1", torch.device("cpu"), 12, 1)
        assert a.shape[0] == 12
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "harl_tpu")
                        and sys.modules[m] is not None)
        assert not loaded, loaded
        print(tuple(state.q.shape))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=SCRIPT.parent.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["(12,", "9)"]
