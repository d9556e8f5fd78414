"""JAX-package parameters → the port's ``state_dict``s.

Takes the flax parameter trees as nested dicts of numpy arrays (convert with
``jax.tree.map(np.asarray, params)`` on the JAX side), so this module never
imports JAX. A flax ``Dense.kernel`` is (in, out) and a torch
``Linear.weight`` (out, in), so kernels are transposed; LayerNorm
``scale``/``bias`` map to ``weight``/``bias``. The GRU's fused weights
(``rnn/wi{i}``, ``wh{i}``, ``bi{i}``, ``bh{i}``) keep the flax layout and copy
as they are, its output LayerNorm is ``rnn/norm``. A ``CNNBase`` torso's
``conv`` kernel is HWIO in flax and OIHW in torch; its Dense rows follow
the (H, W, C) flatten order in both. Covers ``StochasticPolicy`` (MLP or
CNN, optional GRU, Box, Discrete or MultiDiscrete ``head{i}`` heads) and
``VNet`` (MLP or CNN, optional GRU),
the off-policy networks on ``PlainMLP`` (``fc{i}`` → ``fc.{i}``):
``SquashedGaussianPolicy``, ``DeterministicPolicy`` and ``ContinuousQNet``,
the last also as a tuple of twin nets, and HAD3QN's ``DuelingQNet`` (alone,
or as the critic's tuple of one). Discrete HASAC's ``StochasticMlpPolicy``
has ``StochasticPolicy``'s names (``base``, ``act/head``), so
``policy_state_dict`` converts it. ``plain_cnn_state_dict`` converts a
``PlainCNN`` (``conv``, ``fc``).

``off_policy_state`` carries a whole off-policy train state of the JAX
runner into the port: networks, targets, every ``optax.adam`` state as
torch Adam's, α, the replay ring and the env carry. It takes the state
as ``jax.tree.map(np.asarray, state)`` leaves it (NamedTuples of numpy
arrays), and raises on any field it cannot place.
"""
from __future__ import annotations

import warnings
from typing import Callable, Dict, Mapping, Sequence

import numpy as np
import torch

from harl_tpu_torch.buffers.off_policy import AVAIL, ENV_LEVEL, PER_AGENT


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _dense(prefix: str, p: Mapping) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(np.asarray(p["kernel"]).T), f"{prefix}.bias": _t(p["bias"])}


def _layer_norm(prefix: str, p: Mapping) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(p["scale"]), f"{prefix}.bias": _t(p["bias"])}


def _mlp_base(p: Mapping) -> Dict[str, torch.Tensor]:
    """``MLPBase`` or, with a ``conv``, ``CNNBase``."""
    out: Dict[str, torch.Tensor] = {}
    if "conv" in p:
        out.update(_conv("base.conv", p["conv"]))
    if "feature_norm" in p:
        out.update(_layer_norm("base.feature_norm", p["feature_norm"]))
    i = 0
    while f"fc{i}" in p:
        out.update(_dense(f"base.fc.{i}", p[f"fc{i}"]))
        out.update(_layer_norm(f"base.ln.{i}", p[f"ln{i}"]))
        i += 1
    return out


def _conv(prefix: str, p: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``Conv`` (HWIO kernel) → a torch ``Conv2d`` (OIHW weight)."""
    return {f"{prefix}.weight": _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))),
            f"{prefix}.bias": _t(p["bias"])}


def _gru(p: Mapping) -> Dict[str, torch.Tensor]:
    out = {f"rnn.{k}": _t(v) for k, v in p.items() if k != "norm"}
    out.update(_layer_norm("rnn.norm", p["norm"]))
    return out


def _params(tree: Mapping) -> Mapping:
    return tree["params"] if "params" in tree else tree


def policy_state_dict(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """``StochasticPolicy`` parameters: MLP or CNN, optional GRU, Box,
    Discrete or MultiDiscrete heads; also ``StochasticMlpPolicy``'s (MLP,
    Discrete or MultiDiscrete heads)."""
    p = _params(flax_params)
    out = _mlp_base(p["base"])
    if "rnn" in p:
        out.update(_gru(p["rnn"]))
    for name in p["act"]:
        if name.startswith("head"):
            out.update(_dense(f"act.{name}", p["act"][name]))
    if "log_std" in p["act"]:
        out["act.log_std"] = _t(p["act"]["log_std"])
    return out


def vnet_state_dict(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """``VNet`` parameters: MLP, optional GRU."""
    p = _params(flax_params)
    out = _mlp_base(p["base"])
    if "rnn" in p:
        out.update(_gru(p["rnn"]))
    out.update(_dense("v_out", p["v_out"]))
    return out


def plain_mlp_state_dict(flax_params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``PlainMLP``: {fc0, fc1, …} → ``{prefix}fc.{i}``."""
    p = _params(flax_params)
    out: Dict[str, torch.Tensor] = {}
    for i in range(len(p)):
        out.update(_dense(f"{prefix}fc.{i}", p[f"fc{i}"]))
    return out


def squashed_policy_state_dict(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """``SquashedGaussianPolicy``: {"net": {fc0, fc1}, "mu", "log_std"}."""
    p = _params(flax_params)
    out = plain_mlp_state_dict(p["net"], "net.")
    out.update(_dense("mu", p["mu"]))
    out.update(_dense("log_std", p["log_std"]))
    return out


def deterministic_policy_state_dict(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """``DeterministicPolicy``: {"pi": {fc0, fc1, fc2}}."""
    return plain_mlp_state_dict(_params(flax_params)["pi"], "pi.")


def q_net_state_dict(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """``ContinuousQNet``: {"mlp": {fc0, fc1, fc2}}."""
    return plain_mlp_state_dict(_params(flax_params)["mlp"], "mlp.")


def dueling_q_state_dict(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """``DuelingQNet``: {"base", "dueling_v", "dueling_a"}, each a PlainMLP."""
    p = _params(flax_params)
    out: Dict[str, torch.Tensor] = {}
    for name in ("base", "dueling_v", "dueling_a"):
        out.update(plain_mlp_state_dict(p[name], f"{name}."))
    return out


def q_nets_state_dict(flax_params: Sequence[Mapping],
                      net=q_net_state_dict) -> Dict[str, torch.Tensor]:
    """A tuple of Q-net parameters (one, or twins) → the ``state_dict`` of an
    ``nn.ModuleList`` of them; ``net`` converts one (``ContinuousQNet``
    unless given, e.g. ``dueling_q_state_dict``)."""
    return {f"{i}.{k}": v for i, p in enumerate(flax_params) for k, v in net(p).items()}


def plain_cnn_state_dict(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """``PlainCNN`` parameters: ``conv`` and ``fc``."""
    p = _params(flax_params)
    return {**_conv("conv", p["conv"]), **_dense("fc", p["fc"])}


# ------------------------------------------------- the off-policy train state
# The JAX runner's PRNG key has no counterpart in the port, whose draws come
# from its own generators: the one field of the state that is not carried.
NOT_CARRIED = ("rng",)


def _fields(node, names: Sequence[str], what: str) -> dict:
    """``node``'s fields (a NamedTuple or a mapping) as a dict; a field
    outside ``names``, or one of them missing, is an error."""
    d = node._asdict() if hasattr(node, "_asdict") else dict(node)
    if set(d) != set(names):
        raise KeyError(f"{what}: fields {sorted(d)}, the port places {sorted(names)}")
    return d


def _adam_moments(opt_state, what: str) -> tuple:
    """(count, mu, nu) of an ``optax.adam`` state, the chain
    (ScaleByAdamState(count, mu, nu), EmptyState())."""
    scale, *rest = opt_state
    for r in rest:
        _fields(r, (), f"{what}: after the Adam moments")
    f = _fields(scale, ("count", "mu", "nu"), what)
    return int(np.asarray(f["count"])), f["mu"], f["nu"]


def load_adam(opt: torch.optim.Optimizer, named: Mapping[str, torch.Tensor], opt_state,
              to_sd: Callable[[Mapping], Dict[str, torch.Tensor]], what: str) -> None:
    """Carry an ``optax.adam`` state into the torch Adam ``opt`` over the
    parameters ``named`` (name → parameter, named as ``to_sd`` names a
    converted tree): mu, nu and count become exp_avg, exp_avg_sq (in the
    parameter's dtype) and step, the step on the CPU as torch keeps it (``utils/checkpoint.py``
    ``steps_on_cpu``)."""
    count, mu, nu = _adam_moments(opt_state, what)
    mu, nu = to_sd(mu), to_sd(nu)
    held = [p for g in opt.param_groups for p in g["params"]]
    if set(mu) != set(named) or set(nu) != set(named):
        raise KeyError(f"{what}: moments for {sorted(mu)}, parameters {sorted(named)}")
    if {id(p) for p in held} != {id(p) for p in named.values()} or len(held) != len(named):
        raise KeyError(f"{what}: the optimizer holds other parameters than {sorted(named)}")
    for name, p in named.items():
        if mu[name].shape != p.shape or nu[name].shape != p.shape:
            raise ValueError(f"{what}: {name} is {tuple(p.shape)}, its moments "
                             f"{tuple(mu[name].shape)} and {tuple(nu[name].shape)}")
        opt.state[p] = {"step": torch.tensor(float(count), dtype=torch.float32),
                        "exp_avg": mu[name].to(p.device, p.dtype),
                        "exp_avg_sq": nu[name].to(p.device, p.dtype)}


def _load_net(net: torch.nn.Module, sd: Dict[str, torch.Tensor], what: str) -> None:
    own = net.state_dict()
    if set(sd) != set(own):
        raise KeyError(f"{what}: converted {sorted(sd)}, the module has {sorted(own)}")
    net.load_state_dict(sd)


def _load_alpha(log_alpha, alpha_opt, value, opt_state, what: str) -> None:
    """A log α and its Adam; both absent, or both present, on each side."""
    if (log_alpha is None) != (value is None) or (value is None) != (opt_state is None):
        raise KeyError(f"{what}: log α on one side only")
    if value is None:
        return
    with torch.no_grad():
        log_alpha.copy_(_t(value))
    load_adam(alpha_opt, {"log_alpha": log_alpha}, opt_state,
              lambda x: {"log_alpha": _t(x)}, f"{what} α")


def off_policy_converters(runner) -> tuple:
    """(actor i's converter for agent i, the critic's) of an off-policy
    runner of the port: flax tree → the ``state_dict`` of its modules."""
    def actor(i):
        if runner.algo == "had3qn":
            return dueling_q_state_dict
        if runner.algo == "hasac":
            return (squashed_policy_state_dict if runner.actors[i].kind == "Box"
                    else policy_state_dict)
        return deterministic_policy_state_dict

    critic_net = dueling_q_state_dict if runner.algo == "had3qn" else q_net_state_dict
    return actor, lambda params: q_nets_state_dict(params, critic_net)


def load_off_policy_actors(runner, state, actors) -> None:
    """Every actor's net, target, Adam and (HASAC auto-α) log α and its Adam."""
    to_sd = off_policy_converters(runner)[0]
    if len(actors) != len(state.actors):
        raise ValueError(f"{len(actors)} actor states, the port holds {len(state.actors)}")
    for i, (st, jst) in enumerate(zip(state.actors, actors)):
        what = f"actor {i}"
        f = _fields(jst, ("params", "target_params", "opt_state", "log_alpha",
                          "alpha_opt_state"), what)
        conv = to_sd(i)
        _load_net(st.net, conv(f["params"]), what)
        _load_net(st.target, conv(f["target_params"]), f"{what} target")
        load_adam(st.opt, dict(st.net.named_parameters()), f["opt_state"], conv, what)
        _load_alpha(st.log_alpha, st.alpha_opt, f["log_alpha"], f["alpha_opt_state"], what)


def load_off_policy_critic(runner, state, critic) -> None:
    """The critic's nets, targets, Adam, log α with its Adam, and ValueNorm."""
    to_sd = off_policy_converters(runner)[1]
    cs = state.critic
    f = _fields(critic, ("params", "target_params", "opt_state", "log_alpha",
                         "alpha_opt_state", "value_norm"), "critic")
    _load_net(cs.nets, to_sd(f["params"]), "critic")
    _load_net(cs.targets, to_sd(f["target_params"]), "critic target")
    load_adam(cs.opt, dict(cs.nets.named_parameters()), f["opt_state"], to_sd, "critic")
    _load_alpha(cs.log_alpha, cs.alpha_opt, f["log_alpha"], f["alpha_opt_state"], "critic")
    if (cs.value_norm is None) != (f["value_norm"] is None):
        raise KeyError("critic: ValueNorm on one side only")
    if cs.value_norm is not None:
        vn = _fields(f["value_norm"], ("running_mean", "running_mean_sq", "debiasing_term"),
                     "critic ValueNorm")
        for k, v in vn.items():
            getattr(cs.value_norm, k).copy_(_t(v))


def _view(x, rows: slice) -> torch.Tensor:
    """``rows`` of an array as a tensor without a copy, to be copied from:
    a JAX array's numpy view is read-only, which torch warns of."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.from_numpy(np.asarray(x)[rows])


def load_ring(buf, ring, rows: slice = slice(None)) -> None:
    """The replay ring's columns (``rows`` of them, all by default) copied
    into the port's ring in place, and its cursor and ``cur_size``."""
    f = _fields(ring, ENV_LEVEL + PER_AGENT + AVAIL + ("idx", "cur_size"), "replay ring")
    for k in ENV_LEVEL:
        getattr(buf, k)[rows].copy_(_view(f[k], rows))
    for k in PER_AGENT + AVAIL:
        dst, src = getattr(buf, k), f[k]
        if (dst is None) != (src is None) or (src is not None and len(src) != len(dst)):
            raise KeyError(f"replay ring: {k} differs in presence or agents")
        for d, s in zip(dst or (), src or ()):
            d[rows].copy_(_view(s, rows))
    buf.idx, buf.cur_size = int(np.asarray(f["idx"])), int(np.asarray(f["cur_size"]))


def off_policy_carry(carry, template):
    """The rollout carry (env state, obs, state, availability, agent deaths,
    the episode returns so far) as tensors on the device of the port's
    carry ``template``, each of its field's shape and dtype (a mismatch is
    an error); the env state is a NamedTuple of the template's fields."""
    def tensor(x, like, what):
        t = torch.from_numpy(np.array(x, copy=True))
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"carry {what}: {tuple(t.shape)}, the port's {tuple(like.shape)}")
        return t.to(like.device, like.dtype)

    names = type(template)._fields
    f = _fields(carry, names, "carry")
    env_type = type(template.env_state)
    env = _fields(f["env_state"], env_type._fields, "env state")
    if (f["avail"] is None) != (template.avail is None):
        raise KeyError("carry: availability on one side only")
    return type(template)(
        env_state=env_type(**{k: tensor(v, getattr(template.env_state, k), k)
                              for k, v in env.items()}),
        **{k: None if f[k] is None else tensor(f[k], getattr(template, k), k)
           for k in names if k != "env_state"})


def off_policy_state(runner, tree, state=None):
    """The port's ``OffPolicyState`` for ``runner`` (a pure-tensor env on
    one rank) holding the JAX runner's state ``tree``: into ``state`` in
    place where given (its ring keeps its storage), else into a fresh one
    (networks drawn from a generator of its own, so the runner's draws do
    not move). Every field is carried but the PRNG key (``NOT_CARRIED``)."""
    if getattr(runner, "host_mode", False) or runner.mesh.world != 1:
        raise NotImplementedError("off_policy_state carries a pure-tensor env on one rank")
    f = _fields(tree, ("actors", "critic", "buffer", "carry", "total_it") + NOT_CARRIED,
                "off-policy state")
    if state is None:
        from harl_tpu_torch.utils.noise import GeneratorNoise

        gen = torch.Generator(device=runner.device)
        state = runner.new_state(gen, *runner.vec.reset(GeneratorNoise(gen, runner.device)))
    load_off_policy_actors(runner, state, f["actors"])
    load_off_policy_critic(runner, state, f["critic"])
    load_ring(state.buffer, f["buffer"])
    state.carry = off_policy_carry(f["carry"], state.carry)
    state.total_it = int(np.asarray(f["total_it"]))
    return state
