"""The port's CUDA kernels against their plain versions, on a CUDA device.

Marked ``cuda``; each test skips on a host without a CUDA device. This file
imports nothing of JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from harl_tpu_torch.ops import gae_kernels as K

pytestmark = pytest.mark.cuda

# both float32; nvcc fuses multiply-adds that the plain version rounds twice
RTOL = ATOL = 1e-5


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _on(x, device, offset):
    """``x`` on ``device``, contiguous, starting ``offset`` floats into its
    storage: offset 1 leaves it 4-byte but not 16-byte aligned."""
    if x is None:
        return None
    flat = torch.empty(x.numel() + offset, device=device)
    view = flat[offset:].view(x.shape)
    view.copy_(x)
    return view


def _problem(T, trailing, with_bad, device, seed=0, offset=0):
    g = torch.Generator().manual_seed(seed)
    r = torch.randn((T,) + trailing, generator=g)
    v = torch.randn((T + 1,) + trailing, generator=g)
    m = (torch.rand((T + 1,) + trailing, generator=g) > 0.15).float()
    b = (torch.rand((T + 1,) + trailing, generator=g) > 0.1).float() if with_bad else None
    return [_on(x, device, offset) for x in (r, v, m, b)]


# (T, trailing): ragged column tiles (b = 7, 130, 3000, 4100, 5000 are no
# multiple of the tile width the geometry picks: 8, 8, 16, 32, 32), the main
# path's shape, the SMACLite FP layout (256 envs x 5 agents, T=70),
# happo.yaml's defaults (20 envs, T=200), T=1024 over many ring stages, and
# T=33 at b=1
SHAPES = [(9, (7, 1)), (9, (4, 3, 1)), (9, (130, 1)), (32, (4096, 1)), (9, (5000, 1)),
          (70, (256, 5, 1)), (200, (20, 1)), (1024, (4096, 1)), (33, (1, 1)),
          (40, (4100, 1)), (24, (3000, 1))]
# inputs at storage offset 1: the kernels copy 4 bytes at a time there
MISALIGNED = [(32, (4096, 1)), (70, (256, 5, 1))]


@pytest.mark.parametrize("T,trailing", SHAPES)
@pytest.mark.parametrize("with_bad", [True, False])
def test_gae_kernel_matches_plain(device, T, trailing, with_bad):
    r, v, m, b = _problem(T, trailing, with_bad, device)
    before = K.gae.launches
    out = K.gae(r, v, m, b, 0.99, 0.95)
    torch.cuda.synchronize()
    assert K.gae.launches == before + 1
    torch.testing.assert_close(out, K.gae_reference(r, v, m, b, 0.99, 0.95),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("T,trailing", SHAPES)
@pytest.mark.parametrize("with_bad", [True, False])
def test_returns_kernel_matches_plain(device, T, trailing, with_bad):
    r, v, m, b = _problem(T, trailing, with_bad, device, seed=1)
    nv = v[-1].contiguous()
    before = K.discounted_returns.launches
    out = K.discounted_returns(r, v, m, b, nv, 0.99)
    torch.cuda.synchronize()
    assert K.discounted_returns.launches == before + 1
    torch.testing.assert_close(out, K.discounted_returns_reference(r, v, m, b, nv, 0.99),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("T,trailing", MISALIGNED)
@pytest.mark.parametrize("with_bad", [True, False])
def test_kernels_take_inputs_not_16_byte_aligned(device, T, trailing, with_bad):
    r, v, m, b = _problem(T, trailing, with_bad, device, seed=2, offset=1)
    assert r.data_ptr() % 16 != 0 and r.is_contiguous()
    nv = _on(v[-1], device, 1)
    before = (K.gae.launches, K.discounted_returns.launches)
    out_gae = K.gae(r, v, m, b, 0.99, 0.95)
    out_ret = K.discounted_returns(r, v, m, b, nv, 0.99)
    torch.cuda.synchronize()
    assert (K.gae.launches, K.discounted_returns.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(out_gae, K.gae_reference(r, v, m, b, 0.99, 0.95),
                               rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(out_ret, K.discounted_returns_reference(r, v, m, b, nv, 0.99),
                               rtol=RTOL, atol=ATOL)


def test_kernel_refuses_mixed_devices(device):
    r, v, m, b = _problem(4, (3, 1), True, device)
    with pytest.raises(ValueError):
        K.gae(r, v.cpu(), m, b, 0.99, 0.95)


@pytest.mark.parametrize("map_name", ["5m_vs_6m", "2s3z", "MMM", "bane_vs_bane"])
def test_smaclite_steps_on_the_card_equal_the_cpu(device, map_name):
    """30 steps of the same batch with the same actions on both devices.
    Every float operation of the env rounds the same on both (products by
    float32 reciprocals, fused adds formed in float64, a fixed summation
    order: envs/smaclite/smaclite.py), so the state and every feature are
    bitwise equal; only the reward's sum over enemies may reassociate."""
    from harl_tpu_torch.envs.smaclite.smaclite import SMACLiteState, make_smaclite

    envs = [make_smaclite(map_name, torch.device(d), state_type="FP", episode_limit=25)
            for d in ("cpu", device)]
    g = torch.Generator().manual_seed(0)
    X = 32
    u = torch.rand((X, envs[0].reset_noise_dim), generator=g)
    out = [e.reset((u.to(e.device), torch.zeros_like(u, device=e.device))) for e in envs]
    n_agents, n_actions = envs[0].n_agents, envs[0].n_actions
    for _ in range(30):
        (s_cpu, ts_cpu), (s_gpu, ts_gpu) = out
        for k in SMACLiteState._fields:
            assert torch.equal(getattr(s_gpu, k).cpu(), getattr(s_cpu, k)), k
        for k in ("obs", "share_obs", "agent_state", "dones", "bad_transition",
                  "available_actions"):
            assert torch.equal(getattr(ts_gpu, k).cpu(), getattr(ts_cpu, k)), k
        torch.testing.assert_close(ts_gpu.rewards.cpu(), ts_cpu.rewards, rtol=1e-6, atol=1e-7)
        a = torch.randint(0, n_actions, (X, n_agents, 1), generator=g)
        out = [e.step(o[0], a.to(e.device)) for e, o in zip(envs, out)]


def test_cli_hatrpo_iteration_on_the_card(device, tmp_path):
    """One tiny HATRPO iteration of the tuned SMACLite 5m_vs_6m config
    through the entry point, on the card by default: the GAE kernel runs
    once, and the run directory holds finite losses and a checkpoint."""
    import json
    from pathlib import Path

    from harl_tpu_torch import train

    config = Path(__file__).resolve().parent.parent / (
        "tuned_configs/smaclite/5m_vs_6m/hatrpo/config.json")
    before = (K.gae.launches, K.discounted_returns.launches)
    run = Path(train.main(["--load_config", str(config), "--n_rollout_threads", "4",
                           "--episode_length", "20", "--num_env_steps", "80",
                           "--hidden_sizes", "[16, 16]", "--use_eval", "False",
                           "--log_dir", str(tmp_path)]))
    assert (K.gae.launches, K.discounted_returns.launches) == (before[0] + 1, before[1])
    with open(run / "logs" / "progress.txt") as f:
        (rec,) = [json.loads(line) for line in f]
    assert torch.isfinite(torch.tensor(rec["value_loss"]))
    assert len(rec["agent_stats"]) == 5
    assert (run / "models" / "ckpt_80" / "state.pt").exists()
