"""``scripts/torch_planar_width.py`` on the CPU: the planar substeps of one
env step agree row for row at every batch width here, and a width-dependent
op planted in the physics is the op the script names, with its substep and
line."""
import importlib.util
import json
import subprocess
import sys
import textwrap
from pathlib import Path

from harl_tpu_torch.envs.mamujoco_jax import planar

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "torch_planar_width.py"
_spec = importlib.util.spec_from_file_location("torch_planar_width", SCRIPT)
width = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(width)


def _run(tmp_path, name):
    out = tmp_path / name
    assert width.main(["--device", "cpu", "--warm_steps", "2", "--out", str(out)]) == 0
    return json.loads(out.read_text())


def test_the_script_names_a_planted_width_dependent_op(tmp_path, monkeypatch):
    clean = _run(tmp_path, "clean.json")
    assert clean["widths"] == [64, 128, 256] and clean["card"] == "cpu"
    for rec in clean["by_width"].values():
        assert rec["ops"] > 0 and rec["origin"] is None
        assert rec["step_max_abs"] == {"q": 0.0, "qd": 0.0}
    # the solve's right-hand side scaled by 1 + 1e-6 from 128 rows up
    solve = planar.gauss_solve
    monkeypatch.setattr(planar, "gauss_solve",
                        lambda A, b: solve(A, b * (1.0 + 1e-6 * (b.shape[0] // 128))))
    planted = _run(tmp_path, "planted.json")
    for rec in planted["by_width"].values():
        origin = rec["origin"]
        assert origin["op"] == "aten.mul.Tensor" and origin["line"].startswith("substep 1, ")
        line = int(origin["line"].rsplit(":", 1)[1])
        assert "gauss_solve(" in Path(planar.__file__).read_text().splitlines()[line - 1]
        assert origin == rec["first_differing_output"] and origin["shape"] == [64, 9]
        assert origin["first_value_narrow"] != origin["first_value_wide"]
        assert rec["substep_max_abs"]["qd"] > 0


def test_the_script_imports_without_jax():
    """The script, and the physics it records, with JAX, flax, optax and
    harl_tpu made unimportable."""
    code = textwrap.dedent("""
        import importlib.util, sys
        for name in ("jax", "jaxlib", "flax", "optax", "harl_tpu"):
            sys.modules[name] = None
        spec = importlib.util.spec_from_file_location("width", "scripts/torch_planar_width.py")
        width = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(width)
        spec_, q, qd, tau = width.states(0, 64, 1)
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "harl_tpu")
                        and sys.modules[m] is not None)
        assert not loaded, loaded
        print(tuple(q.shape), spec_.frame_skip)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=SCRIPT.parent.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["(64,", "9)", "5"]
