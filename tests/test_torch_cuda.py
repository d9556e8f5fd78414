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


def _same_draws(spec, X, g, envs):
    """One set of reset draws, made on the CPU, handed to every env's device."""
    from harl_tpu_torch.utils.noise import GeneratorNoise

    draws = GeneratorNoise(g, "cpu").reset_noise(X, spec)
    return [tuple(d.to(e.device) for d in draws) for e in envs]


MPE_CASES = [(s, c) for s in ("simple_spread_v2", "simple_reference_v2",
                              "simple_speaker_listener_v3") for c in (True, False)]


@pytest.mark.parametrize("scenario,continuous", MPE_CASES)
def test_mpe_steps_on_the_card_match_the_cpu(device, scenario, continuous):
    """30 auto-reset steps of 64 envs with the same actions and reset draws
    on both devices, through the truncation at max_cycles: obs, share_obs
    and rewards at rtol 1e-5, atol 1e-6; dones, truncations and
    availability equal."""
    from harl_tpu_torch.envs import core, make_env

    envs = [make_env("pettingzoo_mpe", {"scenario": scenario, "continuous_actions": continuous},
                     device=d) for d in ("cpu", device)]
    g, X = torch.Generator().manual_seed(0), 64
    out = [e.reset(d) for e, d in zip(envs, _same_draws(envs[0].reset_noise_spec, X, g, envs))]
    states = [o[0] for o in out]
    ends = 0
    for _ in range(30):
        if continuous:
            a = torch.rand((X, envs[0].n_agents, envs[0].max_action_n), generator=g)
        else:
            a = torch.stack([torch.randint(0, sp.n, (X, 1), generator=g)
                             for sp in envs[0].action_space], dim=1)
        trs = [core.auto_reset_step(e, s, a.to(e.device), d) for e, s, d in
               zip(envs, states, _same_draws(envs[0].reset_noise_spec, X, g, envs))]
        t_cpu, t_gpu = trs[0].ts, trs[1].ts
        for k in ("obs", "share_obs", "rewards"):
            torch.testing.assert_close(getattr(t_gpu, k).cpu(), getattr(t_cpu, k),
                                       rtol=1e-5, atol=1e-6)
        for k in ("dones", "bad_transition") + (() if continuous else ("available_actions",)):
            assert torch.equal(getattr(t_gpu, k).cpu(), getattr(t_cpu, k)), k
        ends += int(t_cpu.dones.all(dim=1).sum())
        states = [tr.state for tr in trs]
    assert ends == X


# (scenario, dof, the offset of q[2] that makes half the envs fail, and the
# velocity added there): Walker2d and Hopper pitched forward, the Ant's torso
# dropped to just above its 0.2 height bound and falling
TERMINATION_CASES = [("Walker2d-v2", 9, 0.97, 4.0), ("Hopper-v2", 6, 0.19, 2.0),
                     ("Ant-v2", 14, -0.5, -8.0)]


@pytest.mark.parametrize("scenario,dof,offset,rate", TERMINATION_CASES)
def test_planar_termination_on_the_card_matches_the_cpu(device, scenario, dof, offset, rate):
    """12 auto-reset steps of 32 envs, half of them tipped over so that they
    terminate unhealthy (dones without truncation) before the truncation at
    step 8: the state and the observations at the planar tolerances (rtol
    1e-4, atol 2e-4), the flags equal. The 3D Ant runs here too."""
    from harl_tpu_torch.envs import core, make_env

    env_args = {"scenario": scenario, "episode_limit": 8}
    envs = [make_env("mamujoco_jax", env_args, device=d) for d in ("cpu", device)]
    g, X = torch.Generator().manual_seed(1), 32
    states = [e.reset(d)[0] for e, d in zip(envs, _same_draws(envs[0].reset_noise_spec, X, g,
                                                              envs))]
    tip = torch.zeros((X, dof))
    tip[::2, 2] = offset
    states = [s._replace(q=s.q + tip.to(s.q.device), qd=s.qd + rate * (tip != 0).to(s.q.device))
              for s in states]
    width = max(sp.dim for sp in envs[0].action_space)
    terminated = 0
    for _ in range(12):
        a = (torch.rand((X, envs[0].n_agents, width), generator=g) - 0.5) * 0.6
        trs = [core.auto_reset_step(e, s, a.to(e.device), d) for e, s, d in
               zip(envs, states, _same_draws(envs[0].reset_noise_spec, X, g, envs))]
        (c, gpu) = trs
        for k in ("q", "qd"):
            torch.testing.assert_close(getattr(gpu.state, k).cpu(), getattr(c.state, k),
                                       rtol=1e-4, atol=2e-4)
        for k in ("obs", "share_obs", "rewards"):
            torch.testing.assert_close(getattr(gpu.ts, k).cpu(), getattr(c.ts, k),
                                       rtol=1e-4, atol=2e-4)
        for k in ("dones", "bad_transition"):
            assert torch.equal(getattr(gpu.ts, k).cpu(), getattr(c.ts, k)), k
        terminated += int((c.ts.dones[:, 0] & ~c.ts.bad_transition).sum())
        states = [tr.state for tr in trs]
    assert terminated >= X // 2


@pytest.mark.parametrize("map_name", ["protoss_5_vs_5", "terran_5_vs_5", "zerg_10_vs_11"])
def test_smacv2_steps_on_the_card_equal_the_cpu(device, map_name):
    """SMACv2 resets (teams and spawns from the same draws) and 30 auto-reset
    steps of 32 envs with the same actions on both devices, through the
    8-step episode limit: unit types, every discrete output and the
    availability equal; floats at rtol 1e-6, atol 1e-7 (the ring's cos and
    sin are formed in float64 on each device)."""
    from harl_tpu_torch.envs import core
    from harl_tpu_torch.envs.smaclite.smaclite import make_smaclite

    envs = [make_smaclite(map_name, torch.device(d), state_type="FP", episode_limit=8)
            for d in ("cpu", device)]
    g, X = torch.Generator().manual_seed(0), 32
    out = [e.reset(d) for e, d in zip(envs, _same_draws(envs[0].reset_noise_spec, X, g, envs))]
    states, ts = [o[0] for o in out], [o[1] for o in out]
    exact = ("ally_type", "enemy_type", "last_action", "enemy_tgt", "t", "battle_over")
    ends = 0
    for _ in range(30):
        (s_cpu, s_gpu), (t_cpu, t_gpu) = states, ts
        for k in exact:
            assert torch.equal(getattr(s_gpu, k).cpu(), getattr(s_cpu, k)), k
        for k in ("ally_pos", "ally_health", "ally_shield", "enemy_pos", "enemy_health"):
            torch.testing.assert_close(getattr(s_gpu, k).cpu(), getattr(s_cpu, k), rtol=1e-6,
                                       atol=1e-7)
        assert torch.equal(t_gpu.available_actions.cpu(), t_cpu.available_actions)
        for k in ("obs", "share_obs", "agent_state"):
            torch.testing.assert_close(getattr(t_gpu, k).cpu(), getattr(t_cpu, k), rtol=1e-6,
                                       atol=1e-7)
        # random available actions, chosen on the CPU
        u = torch.rand(t_cpu.available_actions.shape, generator=g) * t_cpu.available_actions
        a = u.argmax(dim=-1, keepdim=True)
        trs = [core.auto_reset_step(e, st, a.to(e.device), d) for e, st, d in
               zip(envs, states, _same_draws(envs[0].reset_noise_spec, X, g, envs))]
        for k in ("dones", "bad_transition"):
            assert torch.equal(getattr(trs[1].final, k).cpu(), getattr(trs[0].final, k)), k
        ends += int(trs[0].final.dones.all(dim=1).sum())
        states, ts = [tr.state for tr in trs], [tr.ts for tr in trs]
    assert ends >= X


# (env, env_args, the height added to half the torsos): the Humanoid with half
# its torsos lifted past the 2.0 bound (unhealthy on the first step), the
# standup task, and dexhands tasks of each kind: two objects in flight, the
# per-episode layouts, a hinge, two blocks on the table, the Allegro hands
SLICE8_CASES = [("mamujoco_jax", {"scenario": "Humanoid-v2", "obs_standardize": False}, 1.0),
                ("mamujoco_jax", {"scenario": "HumanoidStandup-v2"}, 0.0),
                ("dexhands_jax", {"task": "ShadowHandTwoCatchUnderarm"}, 0.0),
                ("dexhands_jax", {"task": "ShadowHandMetaMT4"}, 0.0),
                ("dexhands_jax", {"task": "ShadowHandDoorOpenOutward"}, 0.0),
                ("dexhands_jax", {"task": "ShadowHandBlockStack"}, 0.0),
                ("dexhands_jax", {"task": "AllegroHandOver", "hands_episode_length": 5}, 0.0)]


@pytest.mark.parametrize("env_name,env_args,lift", SLICE8_CASES,
                         ids=[a.get("task", a.get("scenario")) for _, a, _ in SLICE8_CASES])
def test_hands_and_humanoid_steps_on_the_card_match_the_cpu(device, env_name, env_args, lift):
    """8 auto-reset steps of 32 envs with the same actions and reset draws on
    both devices, each step taken on both from the CPU's state: the states
    and observations at the planar tolerances (rtol 1e-4, atol 2e-4); dones,
    truncations, ``won``, layouts and step counts equal. Each step starts
    from the same state because the penalty contacts amplify a rounding
    difference: one float32 ulp in BlockStack's block positions grows to 4
    of the tolerance within two steps of random actions."""
    from harl_tpu_torch.envs import core, make_env

    envs = [make_env(env_name, env_args, device=d) for d in ("cpu", device)]
    g, X = torch.Generator().manual_seed(2), 32
    states = [e.reset(d)[0] for e, d in zip(envs, _same_draws(envs[0].reset_noise_spec, X, g,
                                                              envs))]
    if lift:
        states = [s._replace(q=s.q + lift * (torch.arange(X, device=s.q.device) % 2 == 0)[:, None]
                             * torch.eye(23, device=s.q.device)[2]) for s in states]
    width = max(sp.dim for sp in envs[0].action_space)
    ends = 0
    for _ in range(8):
        a = torch.rand((X, envs[0].n_agents, width), generator=g) * 2.0 - 1.0
        trs = [core.auto_reset_step(e, s, a.to(e.device), d) for e, s, d in
               zip(envs, states, _same_draws(envs[0].reset_noise_spec, X, g, envs))]
        c, gpu = trs
        for k, v in gpu.state._asdict().items():
            if v.dtype.is_floating_point:
                torch.testing.assert_close(v.cpu(), getattr(c.state, k), rtol=1e-4, atol=2e-4)
            else:
                assert torch.equal(v.cpu(), getattr(c.state, k)), k
        for k in ("obs", "share_obs", "rewards"):
            torch.testing.assert_close(getattr(gpu.final, k).cpu(), getattr(c.final, k),
                                       rtol=1e-4, atol=2e-4)
        for k in ("dones", "bad_transition"):
            assert torch.equal(getattr(gpu.final, k).cpu(), getattr(c.final, k)), k
        for k, v in (c.final.metrics or {}).items():
            assert torch.equal(gpu.final.metrics[k].cpu(), v), k
        ends += int(c.final.dones.all(dim=1).sum())
        states = [c.state, type(c.state)(*(x.to(device) for x in c.state))]
    if lift or env_args.get("hands_episode_length"):
        assert ends >= X // 2
