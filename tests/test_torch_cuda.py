"""The port's CUDA kernels against their plain versions, on a CUDA device,
and with two devices or more the data-parallel collectives over NCCL.

Marked ``cuda``; each test skips on a host without a CUDA device (the NCCL
ones with fewer than two, deciding in their fixture). This file
imports nothing of JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import importlib.util
from pathlib import Path

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


# the ninth slice's envs: soccer (simple, pixels, 10 vs 11), air combat,
# and the swimmer, Reacher, coupled cheetahs and the many-agent ant
SLICE9_CASES = [("football_jax", {"env_name": "academy_3_vs_1_with_keeper", "episode_limit": 6}),
                ("football_jax", {"env_name": "academy_pass_and_shoot_with_keeper",
                                  "representation": "pixels", "episode_limit": 6}),
                ("football_jax", {"env_name": "academy_single_goal_versus_lazy",
                                  "episode_limit": 6}),
                ("lag_jax", {"scenario": "2v2", "episode_limit": 6}),
                ("mamujoco_jax", {"scenario": "manyagent_swimmer", "agent_conf": "10x2",
                                  "episode_limit": 6}),
                ("mamujoco_jax", {"scenario": "Reacher-v2", "episode_limit": 6}),
                ("mamujoco_jax", {"scenario": "coupled_half_cheetah", "episode_limit": 6}),
                ("mamujoco_jax", {"scenario": "manyagent_ant", "agent_conf": "2x3",
                                  "episode_limit": 6})]


@pytest.mark.parametrize("env_name,env_args", SLICE9_CASES,
                         ids=[a.get("env_name", a.get("scenario")) + ("-px" if "representation" in a
                                                                     else "")
                              for _, a in SLICE9_CASES])
def test_slice9_steps_on_the_card_match_the_cpu(device, env_name, env_args):
    """8 auto-reset steps of 32 envs with the same actions and reset draws on
    both devices, each step taken on both from the CPU's state (as the
    dexhands cases): float states and observations at rtol 1e-4, atol 2e-4;
    owners, carriers, checkpoints, alive flags, dones, truncations and
    ``won`` equal; every env truncated at the 6-step limit."""
    from harl_tpu_torch.envs import core, make_env
    from harl_tpu_torch.utils import spaces

    envs = [make_env(env_name, env_args, device=d) for d in ("cpu", device)]
    g, X = torch.Generator().manual_seed(4), 32
    states = [e.reset(d)[0] for e, d in zip(envs, _same_draws(envs[0].reset_noise_spec, X, g,
                                                              envs))]
    sp = envs[0].action_space[0]
    kind = spaces.space_kind(sp)
    ends = 0
    for _ in range(8):
        if kind == "Box":
            a = torch.rand((X, envs[0].n_agents, sp.dim), generator=g) * 2.0 - 1.0
        else:
            ns = (sp.n,) if kind == "Discrete" else sp.nvec
            a = torch.stack([torch.randint(0, n, (X, envs[0].n_agents), generator=g)
                             for n in ns], dim=-1)
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
    assert ends >= X


# ------------------------------------------- data parallelism on one card
# the order of float sums (a rank sums its rows, the all-reduce adds the
# ranks' sums), carried through two iterations of Adam steps
DP_RTOL, DP_ATOL = 1e-5, 1e-6


def _dp_iterations(mesh, device):
    """Two HAPPO HalfCheetah-2x3 iterations (64 envs, 2 minibatches) on
    this rank's env columns (all of them without a mesh); the replicated
    tensors after each, on the CPU, and the GAE launches."""
    from harl_tpu_torch.runners import common
    from harl_tpu_torch.runners.on_policy import OnPolicyRunner
    from harl_tpu_torch.utils.config_tools import get_defaults_yaml_args

    algo_args, env_args = get_defaults_yaml_args("happo", "mamujoco_jax")
    algo_args["train"].update(n_rollout_threads=64, episode_length=16)
    algo_args["model"].update(hidden_sizes=[32, 32])
    algo_args["algo"].update(ppo_epoch=2, critic_epoch=2, actor_num_mini_batch=2,
                             critic_num_mini_batch=2)
    env_args.update(agent_conf="2x3", episode_limit=10)
    runner = OnPolicyRunner({"algo": "happo", "env": "mamujoco_jax"}, algo_args, env_args,
                            device=device)
    runner.use_mesh(mesh)
    state = runner.init_state(0)
    K.gae.launches = 0
    out = []
    for _ in range(2):
        state, _ = runner.train_iteration(state)
        tensors = common.replica_tensors(state)
        out.append(dict(tensors=[t.detach().cpu().clone() for t in tensors],
                        launches=K.gae.launches,
                        mismatch=runner.mesh.replica_mismatch(tensors)))
    return out


def _dp_rank(mesh):
    return _dp_iterations(mesh, mesh.device)


def test_two_gloo_ranks_on_one_card_equal_one_rank(device):
    """Two ranks on ``cuda:0`` over gloo (CUDA tensors): the replicas stay
    bitwise equal, GAE is launched once an iteration on each rank, and
    both equal the one-rank run of this process."""
    from harl_tpu_torch.parallel.launch import spawn_ranks

    ranks = spawn_ranks(_dp_rank, 2, device="cuda:0", backend="gloo", timeout_s=300)
    ref = _dp_iterations(None, device)
    for rank in ranks:
        for i, (got, want) in enumerate(zip(rank, ref)):
            assert got["mismatch"] == (0, 0.0)
            assert got["launches"] == want["launches"] == i + 1
            for a, b in zip(got["tensors"], want["tensors"]):
                torch.testing.assert_close(a, b, rtol=DP_RTOL, atol=DP_ATOL)


# ------------------------------------------ NCCL between cards (several)
def _nccl_rank(mesh):
    """On each rank over NCCL, one card each: rows to gather (with -0.0, a
    NaN, bools, float64 one ulp off 1 and uint8), tensors to sum in three
    dtypes, replicas that agree, and replicas one bit apart on the last
    rank; returns its inputs and what the collectives gave."""
    import torch.distributed as dist

    r, dev = mesh.rank, mesh.device
    rows = (torch.tensor([[-0.0, 1.0 + r], [float("nan"), -2.5]], device=dev),
            torch.tensor([[True], [r % 2 == 1]], device=dev),
            (torch.arange(4, dtype=torch.float64, device=dev).reshape(2, 2) + r) * (1 + 2e-16),
            torch.full((2, 3), r, dtype=torch.uint8, device=dev))
    sums = (torch.full((3,), 0.5 + r, device=dev),
            torch.full((2,), 1.0 + r, dtype=torch.float64, device=dev),
            torch.full((4,), r + 1, dtype=torch.uint8, device=dev))
    off = torch.ones(5, device=dev)
    if r == mesh.world - 1:
        off[2] = torch.nextafter(off[2], torch.tensor(2.0, device=dev))
    return dict(backend=dist.get_backend(), device=str(dev),
                rows=[t.cpu() for t in rows],
                gathered=[t.cpu() for t in mesh.gather_rows(rows)],
                sums=[t.cpu() for t in mesh.all_reduce_sum(sums)],
                equal=mesh.replica_mismatch([torch.ones(5, device=dev),
                                             torch.ones(3, dtype=torch.float64, device=dev)]),
                one_bit=mesh.replica_mismatch([off]))


@pytest.fixture(scope="module")
def nccl_ranks():
    """One spawn of a rank a card over NCCL (skips with fewer than two)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices or more")
    from harl_tpu_torch.parallel.launch import spawn_ranks

    return spawn_ranks(_nccl_rank, torch.cuda.device_count(), device="cuda", backend="nccl",
                       timeout_s=300)


def _bits(x):
    return x.contiguous().reshape(-1).view(torch.uint8)


def test_nccl_gather_rows_is_bitwise(nccl_ranks):
    """Every rank's gathered rows are the ranks' rows in rank order, bit
    for bit: -0.0 stays -0.0, a NaN its payload, bools and uint8 their
    values, float64 its last bit."""
    assert [r["device"] for r in nccl_ranks] == [f"cuda:{k}" for k in range(len(nccl_ranks))]
    for res in nccl_ranks:
        assert res["backend"] == "nccl"
        for i, got in enumerate(res["gathered"]):
            want = torch.cat([r["rows"][i] for r in nccl_ranks])
            assert got.dtype == want.dtype and got.shape == want.shape
            assert torch.equal(_bits(got), _bits(want))
        assert torch.signbit(res["gathered"][0][0, 0])


def test_nccl_all_reduce_sum_in_three_dtypes(nccl_ranks):
    W = len(nccl_ranks)
    for res in nccl_ranks:
        f32, f64, u8 = res["sums"]
        assert (f32.dtype, f64.dtype, u8.dtype) == (torch.float32, torch.float64, torch.uint8)
        assert torch.equal(f32, torch.full((3,), sum(0.5 + r for r in range(W))))
        assert torch.equal(f64, torch.full((2,), sum(1.0 + r for r in range(W)),
                                           dtype=torch.float64))
        assert torch.equal(u8, torch.full((4,), W * (W + 1) // 2, dtype=torch.uint8))


def test_nccl_replica_mismatch_catches_one_bit(nccl_ranks):
    for res in nccl_ranks:
        assert res["equal"] == (0, 0.0)
        bits, diff = res["one_bit"]
        assert bits == 1 and 0.0 < diff < 1e-6


def test_a_restore_keeps_adam_step_counts_on_the_cpu(device, tmp_path):
    """A checkpoint restored onto the card keeps every Adam's step counts
    on the CPU, where torch keeps them (a count on the card costs a host
    sync a parameter at every step), and its moments on the card."""
    from harl_tpu_torch.runners.on_policy import OnPolicyRunner
    from harl_tpu_torch.utils import checkpoint
    from harl_tpu_torch.utils.config_tools import get_defaults_yaml_args

    algo_args, env_args = get_defaults_yaml_args("happo", "mamujoco_jax")
    algo_args["train"].update(n_rollout_threads=8, episode_length=8)
    algo_args["model"].update(hidden_sizes=[16, 16])
    env_args.update(agent_conf="2x3", episode_limit=5)
    runner = OnPolicyRunner({"algo": "happo", "env": "mamujoco_jax"}, algo_args, env_args,
                            device=device)
    state, _ = runner.train_iteration(runner.init_state(0))
    path = checkpoint.save_state(str(tmp_path), runner.checkpoint(state), 1)
    restored = runner.load_checkpoint(runner.init_state(1),
                                      checkpoint.restore_state(path))
    states = [s for st in restored.actors + [restored.critic]
              for s in st.opt.adam.state.values()]
    assert states and all(s["step"].device.type == "cpu" for s in states)
    assert all(s["exp_avg"].device.type == "cuda" for s in states)


@pytest.mark.parametrize("numel", [3, (64 << 20) // 4 + 5, 3 * (64 << 20) // 4 - 7])
def test_copy_to_device_from_a_mapped_file_is_bitwise(device, tmp_path, numel):
    """``checkpoint.copy_to_device`` from a memory-mapped file onto the card:
    below one stage, across two and a ragged third, bitwise (NaN payloads
    and -0.0 included), into the same storage."""
    from harl_tpu_torch.utils import checkpoint

    x = torch.randn(numel)
    x[0], x[-1] = -0.0, float("nan")
    torch.save({"x": x}, tmp_path / "x.pt")
    saved = torch.load(tmp_path / "x.pt", map_location="cpu", mmap=True,
                       weights_only=True)["x"]
    live = torch.zeros(numel, device=device)
    ptr = live.data_ptr()
    checkpoint.copy_to_device(live, saved)
    assert live.data_ptr() == ptr
    assert torch.equal(live.cpu().view(torch.int32), x.view(torch.int32))


def test_fp_restore_on_the_card_keeps_the_ring_in_place(device, tmp_path):
    """A SMACLite FP HASAC runner on the card with a ring of 0.55 GiB (its
    state columns 156 MB, several stages each), restored from its checkpoint into a fresh
    state: the ring keeps its storage, equals the file's bytes, and the
    restore allocates less on the card than one ring column."""
    from harl_tpu_torch.buffers.off_policy import ring_columns
    from harl_tpu_torch.runners.off_policy import OffPolicyRunner
    from harl_tpu_torch.utils import checkpoint
    from harl_tpu_torch.utils.config_tools import get_defaults_yaml_args

    algo_args, env_args = get_defaults_yaml_args("hasac", "smaclite")
    algo_args["train"].update(n_rollout_threads=4, warmup_steps=40, train_interval=5)
    algo_args["algo"].update(batch_size=32, buffer_size=50_000)
    algo_args["model"].update(hidden_sizes=[16, 16])
    env_args.update(map_name="5m_vs_6m", state_type="FP")
    runner = OffPolicyRunner({"algo": "hasac", "env": "smaclite"}, algo_args, env_args,
                             device=device)
    state = runner.warmup_block(runner.init_state(1))
    state, _ = runner.collect_block(state)
    state, _ = runner.train_block(state)
    path = checkpoint.save_state(str(tmp_path), runner.checkpoint(state), 1)
    del state
    live = runner.init_state(2)
    ptrs = [t.data_ptr() for t in live.buffer.tensors()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    restored = runner.restore(live, str(tmp_path))
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated() - before
    assert [t.data_ptr() for t in restored.buffer.tensors()] == ptrs
    assert grew < min(t.nbytes for t in restored.buffer.tensors()[:2])
    saved = checkpoint.restore_state(path)["state"]["buffer"]
    assert restored.buffer.cur_size == saved["cur_size"] == 60
    for a, b in zip(restored.buffer.tensors(), ring_columns(saved.get)):
        assert torch.equal(a.cpu().view(torch.uint8), b.view(torch.uint8))


# ------------------------------------ env rows whatever the batch's width
_WIDTH_SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "torch_planar_width.py"
_width_spec = importlib.util.spec_from_file_location("torch_planar_width", _WIDTH_SCRIPT)
width_check = importlib.util.module_from_spec(_width_spec)
_width_spec.loader.exec_module(width_check)


@pytest.mark.parametrize("name", list(width_check.SCENARIOS))
def test_env_step_rows_do_not_depend_on_the_batch_width(device, name):
    """One ``auto_reset_step`` of every MAMuJoCo-JAX scenario from 4,096
    warmed envs (busiest first, ``scripts/torch_planar_width.py``): the
    head 10 rows of every output are bitwise equal at widths 10, 16, 20,
    256, 512, 2,048 and 4,096."""
    env, *inputs = width_check.warm_inputs(name, device, 4096, 20)
    base = width_check.step_rows(env, inputs, width_check.ROWS, device)
    for w in (16, 20, 256, 512, 2048, 4096):
        rows = width_check.step_rows(env, inputs, w, device)
        assert len(rows) == len(base)
        for i, (a, b) in enumerate(zip(rows, base)):
            assert width_check.same_bits(a, b), f"{name}: output {i} apart at width {w}"
