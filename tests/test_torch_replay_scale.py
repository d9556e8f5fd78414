"""The off-policy path at the tuned configs' scale, on the CPU at tiny sizes:
a resume that restores the replay ring in place (its tensors keep their
storage, the restored state and the next block bitwise those of a runner
that went on without the save), the ring's byte formula against live
rings and the tuned SMACLite FP HASAC configs at 1,000,000 rows, the
refusals, ``scripts/torch_replay_scale.py`` end to end, and
``chip_smoke.py``'s phase 23."""
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from harl_tpu_torch import train
from harl_tpu_torch.buffers.off_policy import (GIB, ReplayBuffer, ReplayBufferFP,
                                               require_room, ring_columns)
from harl_tpu_torch.runners.off_policy import OffPolicyRunner
from harl_tpu_torch.utils import checkpoint
from harl_tpu_torch.utils.config_tools import get_defaults_yaml_args

ROOT = Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "scripts" / "torch_replay_scale.py"
_spec = importlib.util.spec_from_file_location("torch_replay_scale", SCRIPT)
scale = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(scale)
smoke = scale._chip_smoke()

# the tuned SMACLite FP HASAC rings at 1,000,000 rows, GiB: N agents, state
# ds, obs do and Discrete(n) of each map from the port's own spaces, in
# 4·S·(2·N·ds + 2·Σdo + 2·Σn + N + 3·N + N) bytes
TUNED_GIB = {"MMM2": 61.50, "10m_vs_11m": 49.14, "corridor": 36.37, "3s5z_vs_3s6z": 35.97,
             "3s5z": 33.83, "8m_vs_9m": 29.89, "6h_vs_8z": 17.95, "5m_vs_6m": 10.97}
# the tiny CLI runs: 2 envs, a warmup of 40 steps, one block of 10 steps
TINY = ["--n_rollout_threads", "2", "--warmup_steps", "40", "--train_interval", "10",
        "--buffer_size", "300", "--batch_size", "16", "--hidden_sizes", "[8, 8]",
        "--n_eval_rollout_threads", "2", "--eval_episodes", "2"]


def _fp_hasac_runner(buffer_size=14):
    """Discrete FP HASAC on SMACLite 3m with auto-α and ValueNorm, at a ring
    that wraps within a warmup and two blocks."""
    algo_args, env_args = get_defaults_yaml_args("hasac", "smaclite")
    algo_args["train"].update(n_rollout_threads=2, warmup_steps=8, train_interval=4,
                              use_valuenorm=True)
    algo_args["algo"].update(batch_size=8, buffer_size=buffer_size, auto_alpha=True, n_step=3)
    algo_args["model"].update(hidden_sizes=[8, 8])
    env_args.update(map_name="3m", state_type="FP")
    return OffPolicyRunner({"algo": "hasac", "env": "smaclite"}, algo_args, env_args,
                           device="cpu")


def _block(runner, state):
    state, _ = runner.collect_block(state)
    state, metrics = runner.train_block(state)
    return state, metrics


def _equal(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, where
        assert torch.equal(a.view(-1).view(torch.uint8) if a.numel() else a,
                           b.view(-1).view(torch.uint8) if b.numel() else b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def test_fp_resume_restores_the_ring_in_place_and_continues_bitwise(tmp_path):
    """A runner saved after a warmup and a block is restored by a fresh one:
    every ring tensor keeps its storage and equals the saved one bitwise,
    as do the networks, targets, optimizers, α, ValueNorm, carry and both
    generators; the next block equals, bitwise, the block of the runner
    that went on without the save."""
    runner = _fp_hasac_runner()
    state = runner.warmup_block(runner.init_state(3))
    state, _ = _block(runner, state)
    assert state.buffer.cur_size == state.buffer.buffer_size   # the ring wrapped
    saved = runner.checkpoint(state)
    path = checkpoint.save_state(str(tmp_path), saved, 1)
    on_disk = checkpoint.restore_state(path)
    _equal(saved, on_disk)
    state, metrics = _block(runner, state)
    went_on = runner.checkpoint(state)

    fresh = _fp_hasac_runner()
    live = fresh.init_state(11)
    ring = live.buffer.tensors()
    ptrs = [t.data_ptr() for t in ring]
    restored = fresh.restore(live, str(tmp_path))
    assert [t.data_ptr() for t in restored.buffer.tensors()] == ptrs
    assert all(a is b for a, b in zip(restored.buffer.tensors(), ring))
    for a, b in zip(ring, ring_columns(on_disk["state"]["buffer"].get)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    assert restored.critic.value_norm is not None and restored.actors[0].log_alpha is not None
    _equal(fresh.checkpoint(restored), on_disk)
    restored, metrics2 = _block(fresh, restored)
    _equal(fresh.checkpoint(restored), went_on)
    _equal({k: float(v) for k, v in metrics.items() if v.numel() == 1},
           {k: float(v) for k, v in metrics2.items() if v.numel() == 1})


def test_restore_copies_only_into_tensors_that_own_their_storage():
    """``load_payload`` copies into a tensor that is a whole storage no other
    tensor of the live state shares (a module's parameter included), and
    replaces any other, so no copy writes a storage twice nor a tensor
    that is not its own: a view and its base, two names of one tensor, a
    slice, and a leaf that is a module's weight are replaced."""
    net = torch.nn.Linear(2, 3)
    base = torch.zeros(4, 2)
    live = {"own": torch.zeros(5), "base": base, "view": base[1:], "same": [base.view(8)],
            "weight": net.weight.detach(), "net": net, "n": 0, "empty": torch.zeros(0)}
    owners = checkpoint.sole_owners(live)
    assert owners == {(live["own"].device, live["own"].data_ptr()),
                      (net.bias.device, net.bias.data_ptr())}
    saved = {"own": torch.arange(5.0), "base": torch.ones(4, 2), "view": torch.full((3, 2), 2.0),
             "same": [torch.full((8,), 3.0)], "weight": torch.full((3, 2), 4.0),
             "net": {"weight": torch.full((3, 2), 5.0), "bias": torch.full((3,), 6.0)},
             "n": 7, "empty": torch.zeros(0)}
    own_ptr = live["own"].data_ptr()
    out = checkpoint.load_payload(live, saved)
    assert out["own"].data_ptr() == own_ptr and torch.equal(out["own"], torch.arange(5.0))
    for k in ("base", "view", "weight"):
        assert torch.equal(out[k], saved[k]) and out[k].data_ptr() != saved[k].data_ptr()
    assert torch.equal(out["same"][0], saved["same"][0])
    assert torch.equal(base, torch.zeros(4, 2))            # replaced, not written
    assert torch.equal(net.weight, torch.full((3, 2), 5.0)) and out["n"] == 7


def test_an_mmap_restore_leaves_nothing_mapped(tmp_path):
    """After a restore from the memory-mapped file, no tensor of the live
    state (optimizer moments and step counts included) lies in the file's
    mapping, so the checkpoint can be deleted while the run goes on."""
    runner = _fp_hasac_runner()
    state = runner.warmup_block(runner.init_state(3))
    state, _ = _block(runner, state)
    path = checkpoint.save_state(str(tmp_path), runner.checkpoint(state), 1)
    payload = checkpoint.restore_state(path)
    spans = [(t.untyped_storage().data_ptr(), t.untyped_storage().nbytes())
             for t in _tensors(payload) if t.numel()]
    lo, hi = min(p for p, _ in spans), max(p + n for p, n in spans)
    restored = runner.load_checkpoint(runner.init_state(5), payload)
    live = [t.untyped_storage().data_ptr() for t in _tensors(checkpoint.to_payload(restored))]
    assert live and not [p for p in live if lo <= p < hi]
    steps = [s["step"] for st in restored.actors for s in st.opt.state.values()]
    assert steps and all(s.device.type == "cpu" for s in steps)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


@pytest.mark.parametrize("fp,discrete", [(True, True), (False, False), (False, True)])
def test_ring_nbytes_is_the_sum_of_the_live_columns(fp, discrete):
    """The formula (``ring_nbytes``) against the columns a ring allocates, EP
    and FP, with and without availability rows."""
    S, N, ds, obs, act = 37, 3, 11, (4, 6, 5), (1, 2, 3)
    avail = (5, 7, 2) if discrete else None
    if fp:
        buf = ReplayBufferFP(S, N, ds, obs, act, avail_dims=avail)
        want = ReplayBufferFP.ring_nbytes(S, N, ds, obs, act, avail)
    else:
        buf = ReplayBuffer(S, ds, obs, act, avail_dims=avail)
        want = ReplayBuffer.ring_nbytes(S, ds, obs, act, avail)
    assert buf.nbytes == sum(t.nbytes for t in buf.tensors()) == want
    assert len(buf.tensors()) == 5 + 4 * N + (2 * N if discrete else 0)


def test_runner_ring_nbytes_before_allocation():
    """A runner's ``ring_nbytes`` (before ``init_state``) is what it then
    allocates: FP discrete HASAC, and EP continuous HATD3."""
    runner = _fp_hasac_runner(buffer_size=50)
    assert runner.ring_nbytes() == runner.init_state(1).buffer.nbytes
    algo_args, env_args = get_defaults_yaml_args("hatd3", "mamujoco_jax")
    algo_args["train"].update(n_rollout_threads=2)
    algo_args["algo"].update(buffer_size=30, batch_size=8)
    algo_args["model"].update(hidden_sizes=[8, 8])
    env_args.update(agent_conf="2x3")
    runner = OffPolicyRunner({"algo": "hatd3", "env": "mamujoco_jax"}, algo_args, env_args,
                             device="cpu")
    assert runner.ring_nbytes() == runner.init_state(1).buffer.nbytes == 4 * 30 * (
        2 * runner.share_obs_dim + 3 + 2 * sum(runner.obs_dims) + sum(runner.act_dims) + 2)


def test_tuned_smaclite_rings_at_full_size():
    """Each tuned SMACLite FP HASAC config's ring at its 1,000,000 rows, from
    its runner built on the CPU (nothing allocated), to 0.01 GiB."""
    for map_name, gib in TUNED_GIB.items():
        args, algo_args, env_args = train.resolve_args(
            ["--load_config", str(ROOT / scale.config_path(map_name)), "--platform", "cpu",
             "--n_rollout_threads", "1", "--hidden_sizes", "[8, 8]"])
        assert algo_args["algo"]["buffer_size"] == 1000000 and env_args["state_type"] == "FP"
        runner = OffPolicyRunner(args, algo_args, env_args, device="cpu")
        assert runner.ring_nbytes() / GIB == pytest.approx(gib, abs=0.01), map_name
    assert set(TUNED_GIB) == set(scale.MAPS)


def test_require_room_refuses_with_both_numbers():
    require_room(10, 10, "the disk")
    with pytest.raises(ValueError, match=r"the card's memory: 66040000000 bytes \(61\.50 GiB\) "
                                         r"needed, 42949672960 bytes \(40\.00 GiB\) free"):
        require_room(66040000000, 40 * GIB, "the card's memory")


def test_script_refuses_a_short_disk(tmp_path, monkeypatch, capsys):
    """The script checks the disk first and exits non-zero, naming the need
    (the largest ring and 256 MiB) and the free bytes."""
    monkeypatch.setattr(scale.shutil, "disk_usage",
                        lambda p: shutil._ntuple_diskusage(10 ** 9, 10 ** 9 - 1000, 1000))
    code = scale.main(["--platform", "cpu", "--maps", "3s5z", "--log_dir", str(tmp_path),
                       "--out", str(tmp_path / "out"), "--", *TINY])
    assert code == 1
    err = capsys.readouterr().err
    need = scale.planned_ring("3s5z", TINY) + scale.CHECKPOINT_EXTRA
    assert f"{need} bytes" in err and "1000 bytes" in err
    assert not (tmp_path / "out").exists()


def test_script_end_to_end_on_the_cpu(tmp_path):
    """MMM2 through ``train.main`` at tiny widths, then resumed: its JSON
    holds the predicted and allocated ring, the warmup's, the block's and
    the evaluation's seconds and a checkpoint, for each run; the resume
    kept the ring's storage and restored the file's bytes, and every
    checkpoint is gone."""
    out = subprocess.run(
        [sys.executable, str(SCRIPT), "--platform", "cpu", "--maps", "MMM2",
         "--out", str(tmp_path / "out"), "--log_dir", str(tmp_path / "runs"), "--", *TINY],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stdout + out.stderr
    assert json.loads(out.stdout.splitlines()[-1]) == {
        "maps": ["MMM2"], "resumed": ["10m_vs_11m", "MMM2"], "failed": []}
    first = json.loads((tmp_path / "out" / "MMM2.json").read_text())
    for rec in (first, first["resume"]):
        assert rec["predicted_bytes"] == rec["allocated_bytes"] > 0
        assert rec["card"] == "cpu" and rec["buffer_size"] == 300
        assert rec["warmup_s"] > 0 and len(rec["collect_s"]) == len(rec["train_s"]) == 1
        assert len(rec["eval_s"]) == 1 and rec["end_flag_ms"] > 0
        assert len(rec["saves"]) == 1 and rec["saves"][0]["bytes"] > rec["allocated_bytes"]
        assert not os.path.exists(os.path.join(rec["run_dir"], "models"))
    assert "--model_dir" in first["resume"]["argv"] and "restore" not in first
    res = first["resume"]["restore"]
    assert res["storage_kept"] and res["ring_equals_file"] and res["ring_rows"] == 60
    assert res["peak_bytes"] is None     # the CPU has no device peak
    assert "MMM2 restore:" in out.stdout


def test_chip_smoke_phase_23_on_the_cpu(tmp_path):
    """Phase 23's flow at a small ring on the CPU: the ring predicted and
    allocated, a warmup and a block, the checkpoint written to a memory
    file, one more collect, the restore in place through the link under
    the run's directory held by ``check_restore``, the link removed, and
    no GAE launch."""
    launches = smoke.drive_replay_scale_path(
        "cpu", str(tmp_path), device="cpu",
        shrink=("--platform", "cpu", "--n_rollout_threads", "2", "--buffer_size", "500",
                "--hidden_sizes", "[8, 8]", "--batch_size", "16", "--warmup_steps", "40",
                "--train_interval", "10"))
    assert launches == {f"replay_scale_{smoke.REPLAY_MAP}": {"gae": 0,
                                                            "discounted_returns": 0}}
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("ballast", [0, 70 * GIB])
def test_check_restore_catches_each_fault(ballast):
    """``check_restore`` passes a good restore and raises on each fault; a
    ballast that fills the card counts for nothing against the bound."""
    good = dict(storage_kept=True, ring_equals_file=True, peak_bytes=5 * GIB + ballast,
                ring_bytes=2 * GIB, ballast_bytes=ballast)
    smoke.check_restore(good, "x")
    for fault, match in ((dict(storage_kept=False), "changed storage"),
                         (dict(ring_equals_file=False), "differs"),
                         (dict(peak_bytes=6 * GIB + ballast), "during the restore")):
        with pytest.raises(AssertionError, match=match):
            smoke.check_restore({**good, **fault}, "x")


def test_equal_in_chunks_compares_bytes():
    a = torch.arange(10, dtype=torch.float32)
    assert smoke.equal_in_chunks(a, a.clone(), chunk_bytes=12)
    b = a.clone()
    b[7] = -0.0 if a[7] == 0 else a[7] + 1
    assert not smoke.equal_in_chunks(a, b, chunk_bytes=12)
    z = torch.zeros(3)
    assert not smoke.equal_in_chunks(z, -z, chunk_bytes=4)     # -0.0 is another byte
