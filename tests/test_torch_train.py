"""The port's entry point, ``python -m harl_tpu_torch.train``, on the CPU
(``--platform cpu``): argument parsing and config handling against the JAX
package's, tiny training runs that write the run directory, a bitwise
resume, the device rule, and every tuned config of the ported envs."""
import glob
import json
import os
from pathlib import Path

import pytest
import torch

from harl_tpu import train as jtrain
from harl_tpu.utils import config_tools as jconfig
from harl_tpu_torch import train
from harl_tpu_torch.runners.off_policy import OffPolicyRunner
from harl_tpu_torch.runners.on_policy import OnPolicyRunner
from harl_tpu_torch.utils import checkpoint
from harl_tpu_torch.utils import config_tools as tconfig

ROOT = Path(__file__).resolve().parent.parent
SMAC_HATRPO = str(ROOT / "tuned_configs/smaclite/5m_vs_6m/hatrpo/config.json")
CHEETAH = ROOT / "tuned_configs/mamujoco_jax"
# tiny widths and batches for the CPU; the configs' own structure otherwise
TINY_ON = ["--platform", "cpu", "--n_rollout_threads", "2", "--episode_length", "10",
           "--hidden_sizes", "[8, 8]", "--n_eval_rollout_threads", "2", "--eval_episodes", "2",
           "--episode_limit", "6"]
TINY_OFF = ["--platform", "cpu", "--n_rollout_threads", "2", "--warmup_steps", "8",
            "--train_interval", "2", "--batch_size", "8", "--buffer_size", "200",
            "--hidden_sizes", "[8, 8]", "--episode_limit", "5", "--eval_interval", "4",
            "--n_eval_rollout_threads", "2", "--eval_episodes", "2"]

ARGV = ["--lr", "0.001", "--hidden_sizes", "[32, 32]", "--use_eval", "False", "--seed", "7",
        "--map_name", "3m", "--verbose", "--state_type", "FP", "--model_dir", "runs/x",
        "--gamma", "1e-1"]


def test_parse_unknown_and_update_args_match_jax():
    parsed = train._parse_unknown(ARGV)
    assert parsed == jtrain._parse_unknown(ARGV)
    assert parsed["verbose"] is True and parsed["hidden_sizes"] == [32, 32]
    for algo, env in (("hatrpo", "smaclite"), ("mappo", "mamujoco_jax"), ("hasac", "smaclite")):
        # the algo YAMLs are copies; the port's mamujoco_jax.yaml defaults to
        # the planar HalfCheetah, the JAX one to manyagent_swimmer
        t_algo, t_env = tconfig.get_defaults_yaml_args(algo, env)
        j_algo, j_env = jconfig.get_defaults_yaml_args(algo, env)
        assert t_algo == j_algo
        tconfig.update_args(parsed, t_algo, t_env)
        jconfig.update_args(parsed, j_algo, j_env)
        assert t_algo == j_algo
        assert all(t_env.get(k) == j_env.get(k) for k in parsed if k in t_env or k in j_env)
        assert t_algo["seed"] == {"seed_specify": True, "seed": 7}   # a leaf, not the section
        assert t_algo["train"]["model_dir"] == "runs/x"
        # only keys the YAMLs have are overridden: no map_name for mamujoco_jax
        assert t_env.get("map_name") == ("3m" if env == "smaclite" else None)


def test_init_dir_layout_and_config_round_trip(tmp_path):
    env_args = {"map_name": "5m_vs_6m", "state_type": "FP"}
    for env, args in (("smaclite", env_args), ("mamujoco_jax", {"scenario": "HalfCheetah-v2"}),
                      ("smac", env_args)):
        t_run, t_log, t_save = tconfig.init_dir(env, args, "hatrpo", "exp", 3, str(tmp_path / "t"))
        j_run, j_log, j_save = jconfig.init_dir(env, args, "hatrpo", "exp", 3, str(tmp_path / "j"))
        t_rel = Path(t_run).relative_to(tmp_path / "t")
        j_rel = Path(j_run).relative_to(tmp_path / "j")
        assert t_rel.parts[:-1] == j_rel.parts[:-1]
        assert t_rel.parts[-1].startswith("seed-00003-") and j_rel.parts[-1][:11] == "seed-00003-"
        assert (Path(t_log).name, Path(t_save).name) == ("logs", "models")
        assert os.path.isdir(t_log) and os.path.isdir(t_save)
    main_args = {"algo": "hatrpo", "env": "smaclite", "exp_name": "exp", "load_config": ""}
    algo_args, _ = tconfig.get_defaults_yaml_args("hatrpo", "smaclite")
    tconfig.save_config(main_args, algo_args, env_args, t_run)
    assert tconfig.load_config(os.path.join(t_run, "config.json")) == (main_args, algo_args,
                                                                      env_args)
    assert jconfig.load_config(os.path.join(t_run, "config.json"))[1] == algo_args


def _run_dir(log_dir):
    (run,) = glob.glob(str(log_dir / "*/*/*/*/seed-*"))
    return Path(run)


def _records(run):
    with open(run / "logs" / "progress.txt") as f:
        return [json.loads(line) for line in f]


def test_main_hatrpo_writes_the_run_directory(tmp_path):
    run = Path(train.main(["--load_config", SMAC_HATRPO, *TINY_ON, "--num_env_steps", "40",
                           "--eval_interval", "1", "--log_interval", "1",
                           "--log_dir", str(tmp_path)]))
    assert run == _run_dir(tmp_path)
    # the task of smaclite is its env name, the experiment the CLI's --exp_name
    assert run.relative_to(tmp_path).parts[:4] == ("smaclite", "smaclite", "hatrpo",
                                                   "installtest")
    cfg = json.loads((run / "config.json").read_text())
    assert cfg["main_args"]["algo"] == "hatrpo" and cfg["algo_args"]["device"]["platform"] == "cpu"
    assert cfg["algo_args"]["train"]["n_rollout_threads"] == 2
    recs = _records(run)
    train_recs = [r for r in recs if "value_loss" in r]
    evals = [r for r in recs if "eval_return" in r]
    assert [r["steps"] for r in train_recs] == [20, 40] and len(evals) == 2
    assert len(train_recs[-1]["agent_stats"]) == 5
    assert all(torch.isfinite(torch.tensor(r["value_loss"])) for r in train_recs)
    assert "eval_win_rate" in evals[-1]
    assert sorted(os.listdir(run / "models")) == ["ckpt_20", "ckpt_40"]


def test_main_hasac_writes_the_run_directory(tmp_path):
    conf = str(CHEETAH / "HalfCheetah-v2-2x3/hasac/config.json")
    run = Path(train.main(["--load_config", conf, *TINY_OFF, "--num_env_steps", "24",
                           "--log_dir", str(tmp_path)]))
    recs = _records(run)
    # 6 blocks of 2 steps x 2 envs after 8 warmup steps; a record every 2 blocks
    assert [r["steps"] for r in recs] == [16, 24, 32] and "eval_return" in recs[-1]
    assert all(torch.isfinite(torch.tensor(r["critic_loss"])) for r in recs)
    # a checkpoint at the last block only (every 10 blocks otherwise), the newest 2 kept
    assert os.listdir(run / "models") == ["ckpt_32"]
    payload = checkpoint.restore_state(str(run / "models" / "ckpt_32"), torch.device("cpu"))
    buf = payload["state"]["buffer"]
    assert buf["cur_size"] == 8 + 6 * 2 * 2 and buf["share_obs"].shape == (200, 17)


def _final_payload(run):
    return checkpoint.restore_state(checkpoint.latest_checkpoint(str(run)), torch.device("cpu"))


def _assert_payloads_equal(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_payloads_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_payloads_equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def test_resume_continues_bitwise(tmp_path):
    """Two iterations, then one more from their checkpoint (``--model_dir``),
    end where three uninterrupted iterations end: networks, optimizers,
    ValueNorm, the env carry and the generator, bitwise."""
    conf = str(CHEETAH / "HalfCheetah-v2-2x3/hatrpo/config.json")
    common = ["--load_config", conf, *TINY_ON, "--use_eval", "False"]
    first = Path(train.main(common + ["--num_env_steps", "40", "--log_dir",
                                      str(tmp_path / "a")]))
    resumed = Path(train.main(common + ["--num_env_steps", "20", "--model_dir", str(first),
                                        "--log_dir", str(tmp_path / "b")]))
    straight = Path(train.main(common + ["--num_env_steps", "60", "--log_dir",
                                         str(tmp_path / "c")]))
    a, b = _final_payload(resumed), _final_payload(straight)
    _assert_payloads_equal(a, b)
    first_params = _final_payload(first)["state"]["actors"][0]["net"]
    assert not all(torch.equal(v, a["state"]["actors"][0]["net"][k])
                   for k, v in first_params.items())


def test_main_raises_without_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    argv = ["--load_config", SMAC_HATRPO, "--log_dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(argv)
    with pytest.raises(ValueError, match="platform"):
        train.main(argv + ["--platform", "tpu"])
    for key in ("n_devices", "num_processes"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            train.main(argv + ["--platform", "cpu", f"--{key}", "2"])
    assert not os.listdir(tmp_path)   # refused before any run directory was made


NINE = ("happo", "hatrpo", "haa2c", "mappo", "hasac", "haddpg", "hatd3", "maddpg", "matd3")
ON = ("happo", "hatrpo", "haa2c", "mappo")
# every pettingzoo_mpe config, and every Walker2d and Hopper one (71)
MPE_AND_PLANAR = (
    [f"pettingzoo_mpe/{s}-continuous/{a}" for s in
     ("simple_spread_v2", "simple_reference_v2", "simple_speaker_listener_v3") for a in NINE]
    + [f"pettingzoo_mpe/simple_reference_v2-discrete/{a}" for a in ON + ("hasac",)]
    + [f"pettingzoo_mpe/{s}-discrete/{a}" for s in
       ("simple_spread_v2", "simple_speaker_listener_v3") for a in ON + ("hasac", "had3qn")]
    + ["pettingzoo_mpe/simple_spread/happo"]
    + [f"mamujoco_jax/Walker2d-v2-{c}/{a}" for c in ("2x3", "6x1") for a in NINE]
    + [f"mamujoco_jax/Hopper-v2-3x1/{a}" for a in NINE if a != "hasac"])
# every smaclite HASAC config (the FP replay buffer), every SMACv2 config and
# every Ant config (29)
FP_SMACV2_ANT = (
    [f"smaclite/{m}/hasac" for m in ("10m_vs_11m", "3s5z", "3s5z_vs_3s6z", "5m_vs_6m",
                                     "6h_vs_8z", "8m_vs_9m", "MMM2", "corridor")]
    + [f"smacv2/{m}/{a}" for m in ("protoss_5_vs_5", "terran_5_vs_5", "zerg_10_vs_10",
                                   "zerg_10_vs_11", "zerg_5_vs_5") for a in ("happo", "hatrpo")]
    + [f"mamujoco_jax/Ant-v2-4x2/{a}" for a in NINE]
    + ["mamujoco_jax/Ant-v2-2x4/hasac", "mamujoco_jax/Ant-v2-8x1/hasac"])
# every dexhands_jax config, and every Humanoid and HumanoidStandup one (16)
DEXHANDS_HUMANOID = (
    [f"dexhands_jax/{t}/hasac" for t in (
        "ShadowHandCatchAbreast", "ShadowHandCatchOver2Underarm", "ShadowHandDoorCloseInward",
        "ShadowHandDoorOpenInward", "ShadowHandDoorOpenOutward", "ShadowHandLiftUnderarm",
        "ShadowHandOver", "ShadowHandPen", "ShadowHandTwoCatchUnderarm")]
    + [f"dexhands_jax/{t}/happo" for t in ("ShadowHandCatchOver2Underarm", "ShadowHandOver",
                                           "ShadowHandPen")]
    + [f"mamujoco_jax/Humanoid-v2-17x1/{a}" for a in ("happo", "hatd3", "mappo")]
    + ["mamujoco_jax/HumanoidStandup-v2-17x1/hasac"])
REFUSED = ([f"football_jax/{m}/happo" for m in (
    "academy_3_vs_1_with_keeper", "academy_counterattack_easy", "academy_counterattack_hard",
    "academy_pass_and_shoot_with_keeper", "academy_run_pass_and_shoot_with_keeper")]
    + ["lag_jax/2v2/happo", "mamujoco_jax/manyagent_swimmer-10x2/hasac"])
MUST_BUILD = ([f"mamujoco_jax/HalfCheetah-v2-2x3/{a}" for a in NINE]
              + ["mamujoco_jax/HalfCheetah-v2-6x1/happo", "mamujoco_jax/HalfCheetah-v2-6x1/hasac",
                 "smaclite/5m_vs_6m/happo", "smaclite/5m_vs_6m/hatrpo"] + MPE_AND_PLANAR
              + FP_SMACV2_ANT + DEXHANDS_HUMANOID)


def test_every_tuned_config_builds_or_names_its_roadmap_item():
    built, refused = [], {}
    paths = sorted(glob.glob(str(ROOT / "tuned_configs/*/*/*/config.json")))
    assert len(paths) == 156 and len(MPE_AND_PLANAR) == len(set(MPE_AND_PLANAR)) == 71
    assert len(FP_SMACV2_ANT) == len(set(FP_SMACV2_ANT)) == 29
    assert len(DEXHANDS_HUMANOID) == len(set(DEXHANDS_HUMANOID)) == 16
    for path in paths:
        name = str(Path(path).parent.relative_to(ROOT / "tuned_configs"))
        main_args, algo_args, env_args = tconfig.load_config(path)
        tconfig.update_args({"n_rollout_threads": 2, "platform": "cpu"}, algo_args, env_args)
        assert train.select_device(algo_args) == torch.device("cpu")
        runner_cls = OnPolicyRunner if main_args["algo"] in train.ON_POLICY else OffPolicyRunner
        try:
            runner_cls(main_args, algo_args, env_args, device="cpu")
            built.append(name)
        except NotImplementedError as e:
            assert "ROADMAP" in str(e), (name, str(e))
            refused[name] = str(e)
    missing = [n for n in MUST_BUILD if n not in built]
    assert not missing, {n: refused.get(n) for n in missing}
    assert len(built) + len(refused) == len(paths)
    assert len(built) >= 149, (len(built), refused)
    # the 7 left: football_jax 5, manyagent_swimmer 1, lag_jax 1, each naming its item
    assert sorted(refused) == sorted(REFUSED), sorted(refused)
    for name, msg in refused.items():
        assert "remaining pure-JAX envs" in msg, (name, msg)


def test_render_and_profile_trace(tmp_path):
    """``use_render`` saves the deterministic trajectories of a restored
    run as render.npz; ``profile_trace_dir`` (a train key no YAML carries,
    so set in the config) writes a torch.profiler trace of iterations 2-4."""
    import numpy as np

    conf = str(CHEETAH / "HalfCheetah-v2-2x3/mappo/config.json")
    main_args, algo_args, env_args = tconfig.load_config(conf)
    tconfig.update_args(train._parse_unknown(TINY_ON), algo_args, env_args)
    algo_args["train"].update(num_env_steps=100, profile_trace_dir=str(tmp_path / "trace"))
    OnPolicyRunner(main_args, algo_args, env_args, device="cpu").run(seed=1)
    (trace,) = os.listdir(tmp_path / "trace")
    assert trace.endswith(".json") and os.path.getsize(tmp_path / "trace" / trace) > 0

    common = ["--load_config", conf, *TINY_ON, "--use_eval", "False"]
    first = Path(train.main(common + ["--num_env_steps", "20", "--log_dir", str(tmp_path / "a")]))
    run = Path(train.main(common + ["--use_render", "True", "--render_episodes", "3",
                                    "--model_dir", str(first), "--log_dir",
                                    str(tmp_path / "b")]))
    with np.load(run / "render.npz") as f:
        assert f["obs"].shape[:2] == (6, 3) and f["rewards"].shape == (6, 3)
        assert np.isfinite(f["actions"]).all()


def test_dexhands_win_rate_reaches_the_logs_and_eval(tmp_path):
    """A tuned dexhands config through the CLI at small widths: ``won`` is
    logged as ``win_rate`` at episode ends and as ``eval_win_rate``, and the
    eval horizon is the task's ``hands_episode_length``."""
    conf = str(ROOT / "tuned_configs/dexhands_jax/ShadowHandPen/happo/config.json")
    run = Path(train.main(["--load_config", conf, *TINY_ON, "--hands_episode_length", "5",
                           "--use_eval", "True",
                           "--num_env_steps", "20", "--log_interval", "1",
                           "--eval_interval", "1", "--log_dir", str(tmp_path)]))
    recs = _records(run)
    train_recs = [r for r in recs if "value_loss" in r]
    evals = [r for r in recs if "eval_return" in r]
    assert train_recs and all("win_rate" in r for r in train_recs)
    assert evals and 0.0 <= evals[-1]["eval_win_rate"] <= 1.0
    main_args, algo_args, env_args = tconfig.load_config(str(run / "config.json"))
    runner = OnPolicyRunner(main_args, algo_args, env_args, device="cpu")
    assert runner._eval_len() == 5
