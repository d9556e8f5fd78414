"""``chip_smoke.py``'s phase 24 on the CPU at test widths: the tuned HASAC
HalfCheetah-6x1 runner set to a late state and held one unit at a time
against a second runner fed its state and draws, every env truncated and
reset once in the held steps; and the same drive with a fault planted in
the second runner's collect step or update, which the phase must catch."""
import importlib.util
from pathlib import Path

import pytest
import torch

from harl_tpu_torch.runners.off_policy import OffPolicyRunner

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke_late", ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

# 2 envs of a 30-step limit, each set to be truncated in the warmup's 40
# steps; a ring of 410 of 1,000 rows; 10 held units, every env set to end
# once in them
SHRINK = ("--platform", "cpu", "--n_rollout_threads", "2", "--hidden_sizes", "[8, 8]",
          "--batch_size", "16", "--buffer_size", "1000", "--warmup_steps", "80",
          "--episode_limit", "30")
UNITS = 10


def _faulty(method: str, fault):
    """``OffPolicyRunner.<method>`` with ``fault(state)`` applied after it
    in the runner that replays recorded draws (the phase's CPU side)."""
    real = getattr(OffPolicyRunner, method)

    def wrapped(self, state):
        state, metrics = real(self, state)
        if isinstance(self.base_noise, smoke.QueuedNoise):
            fault(state)
        return state, metrics
    return wrapped


def _bump_reward(state):
    state.buffer.rewards[(state.buffer.idx - 1) % state.buffer.buffer_size] += 1e-2


def _bump_param(state):
    with torch.no_grad():
        next(state.actors[0].net.parameters()).view(-1)[0] += 1e-3


def test_chip_smoke_phase_24_on_the_cpu(capsys):
    """The phase passes and reports every env's one episode end."""
    out = smoke.drive_late_hasac_path("cpu", device="cpu", shrink=SHRINK, n_units=UNITS)
    assert out == {"late_hasac_card_vs_cpu": {"gae": 0, "discounted_returns": 0}}
    line = capsys.readouterr().out
    assert "a ring of 410 rows (80 rows of warmup repeated whole)" in line
    assert f"{UNITS} collect steps (2 episodes ended)" in line


@pytest.mark.parametrize("method,fault,quantity", [
    ("collect_block", _bump_reward, "insert.rewards"),
    ("train_block", _bump_param, "actor.params"),
])
def test_phase_24_catches_a_planted_fault(monkeypatch, method, fault, quantity):
    """A reward of the CPU side's inserted row, or one of its actor's
    parameters after an update, moved past the tolerance: the phase raises
    and names the quantity."""
    monkeypatch.setattr(OffPolicyRunner, method, _faulty(method, fault))
    with pytest.raises(AssertionError, match=f"card against CPU: .*'{quantity}'"):
        smoke.drive_late_hasac_path("cpu", device="cpu", shrink=SHRINK, n_units=2)


def test_set_truncations_spreads_them_and_refuses_a_window_past_the_limit():
    """Env ``e`` of 3 is truncated at its ``1 + e·(within − 1)//2``-th
    step; the window must be inside the limit."""
    from types import SimpleNamespace

    state = SimpleNamespace(carry=SimpleNamespace(env_state=SimpleNamespace(
        t=torch.zeros(3, dtype=torch.int32))))
    smoke.set_truncations(state, 30, 9)
    assert state.carry.env_state.t.tolist() == [29, 25, 21]
    for within in (0, 30):
        with pytest.raises(ValueError, match=f"within {within} steps of a 30-step limit"):
            smoke.set_truncations(state, 30, within)
