"""Port parity: MultiDiscrete heads (on-policy sample and evaluate, HASAC's
per-sub-head straight-through sample, the warmup draw, the one-hot joint
action) and the ``CNNBase`` torso, against the JAX package.

Flax parameters are perturbed and copied into the port through
``utils/convert.py`` (``head{i}``; the conv kernel HWIO → OIHW); the draws
are replayed from the JAX keys (``tests/torch_replay.py``: a split per
sub-head on-policy, ``fold_in`` per sub-head in HASAC). The entropy is the
sum of the sub-entropies, then the masked mean (the JAX package's fix of
the reference's broadcasting). Floats at rtol 1e-5 / atol 1e-5, the
tolerance of ``tests/test_torch_models.py``; indices equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harl_tpu.algos import off_policy_actors as jactors
from harl_tpu.algos.q_critics import encode_joint_actions as jencode
from harl_tpu.models import act as jact
from harl_tpu.models.cnn import CNNBase as JCNNBase
from harl_tpu.models.policies import StochasticPolicy as JPolicy
from harl_tpu.models.values import VNet as JVNet
from harl_tpu.utils import spaces as jspaces
from harl_tpu_torch.algos import off_policy_actors as tactors
from harl_tpu_torch.algos.q_critics import encode_joint_actions, onehot_dim
from harl_tpu_torch.models import act as tact
from harl_tpu_torch.models.cnn import CNNBase
from harl_tpu_torch.models.policies import StochasticMlpPolicy, StochasticPolicy
from harl_tpu_torch.models.values import VNet
from harl_tpu_torch.utils import convert, spaces

from tests.torch_replay import ReplayNoise, multi_gumbel_fold_in, multi_gumbel_split, randint

RTOL = ATOL = 1e-5
NVEC = (11, 11, 10)
OBS_DIM, HIDDEN, BATCH = 12, (16, 16), 9
IMAGE = (6, 8, 4)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.3 * rng.normal(size=x.shape)).astype(np.float32), params)


def _md_policy(seed=0):
    jpol = JPolicy(action_space=jspaces.MultiDiscrete(NVEC), hidden_sizes=HIDDEN)
    obs = np.random.default_rng(seed).normal(size=(BATCH, OBS_DIM)).astype(np.float32)
    params = _perturbed(jpol.init(jax.random.PRNGKey(seed), jnp.asarray(obs)), seed + 1)
    tpol = StochasticPolicy(OBS_DIM, spaces.MultiDiscrete(NVEC), HIDDEN, device="cpu")
    tpol.load_state_dict(convert.policy_state_dict(params))
    return jpol, params, tpol, obs


def test_multidiscrete_space_widths():
    sp = spaces.MultiDiscrete(NVEC)
    assert spaces.space_kind(sp) == "MultiDiscrete" and sp.shape == (3,) and sp.dim == 3
    assert onehot_dim(sp) == 32
    img = spaces.ImageBox(*IMAGE)
    assert spaces.space_kind(img) == "ImageBox" and img.shape == IMAGE and img.dim == 192


def test_multidiscrete_sample_and_evaluate_match_jax():
    jpol, params, tpol, obs = _md_policy()
    jhead, _ = jpol.apply(params, jnp.asarray(obs))
    thead, _ = tpol(torch.from_numpy(obs))
    assert len(thead) == 3 and [h.shape[-1] for h in thead] == list(NVEC)
    for t, j in zip(thead, jhead):
        _close(t.detach(), j)
    sp = spaces.MultiDiscrete(NVEC)
    jsp = jspaces.MultiDiscrete(NVEC)
    key = jax.random.PRNGKey(5)
    shapes = [h.shape for h in thead]
    g = [torch.from_numpy(np.array(x)) for x in multi_gumbel_split(key, shapes)]
    jout = jact.act_sample(key, jhead, jsp)
    tout = tact.act_sample(g, thead, sp)
    np.testing.assert_array_equal(tout.actions.numpy(), np.asarray(jout.actions))
    assert tout.actions.shape == (BATCH, 3) and tout.log_probs.shape == (BATCH, 1)
    _close(tout.log_probs.detach(), jout.log_probs)
    jmode = jact.act_sample(key, jhead, jsp, deterministic=True)
    tmode = tact.act_sample(None, thead, sp, deterministic=True)
    np.testing.assert_array_equal(tmode.actions.numpy(), np.asarray(jmode.actions))
    masks = (np.arange(BATCH) % 3 != 0).astype(np.float32)[:, None]
    for am in (None, masks):
        jev = jact.act_evaluate(jhead, jsp, jout.actions,
                                active_masks=None if am is None else jnp.asarray(am))
        tev = tact.act_evaluate(thead, sp, tout.actions,
                                active_masks=None if am is None else torch.from_numpy(am))
        _close(tev.log_probs.detach(), jev.log_probs)
        _close(tev.entropy.detach(), jev.entropy)
    # the masked mean of the summed sub-entropies, not the reference's broadcast
    ent = sum(torch.distributions.Categorical(logits=h).entropy() for h in thead).detach()
    _close(tev.entropy.detach(), (ent * torch.from_numpy(masks[:, 0])).sum() / masks.sum())


def test_hasac_multidiscrete_actor_matches_jax():
    cfg = {"lr": 1e-3, "polyak": 0.005, "hidden_sizes": list(HIDDEN)}
    ja = jactors.HASACActor(OBS_DIM, jspaces.MultiDiscrete(NVEC), cfg)
    ta = tactors.HASACActor(OBS_DIM, spaces.MultiDiscrete(NVEC), cfg, device="cpu")
    assert ta.act_dim == 3 and ta.kind == "MultiDiscrete"
    obs = np.random.default_rng(2).normal(size=(BATCH, OBS_DIM)).astype(np.float32)
    params = _perturbed(ja.init(jax.random.PRNGKey(0)).params, 3)
    net = StochasticMlpPolicy(OBS_DIM, spaces.MultiDiscrete(NVEC), HIDDEN, device="cpu")
    net.load_state_dict(convert.policy_state_dict(params))
    key = jax.random.PRNGKey(7)
    noise = ReplayNoise()
    noise.gumbels.extend(multi_gumbel_fold_in(key, [(BATCH, n) for n in NVEC]))
    eps = ta.draw(noise, BATCH)
    assert noise.drained()
    t_obs = torch.from_numpy(obs)
    ja_oh, ja_lp = ja.get_actions_with_logprobs(params, jnp.asarray(obs), key)
    ta_oh, ta_lp = ta.get_actions_with_logprobs(net, t_obs, eps)
    _close(ta_oh.detach(), ja_oh)
    _close(ta_lp.detach(), ja_lp)
    assert ta_oh.shape == (BATCH, 32) and ta_lp.shape == (BATCH, 3)
    np.testing.assert_array_equal(ta.get_actions(net, t_obs, eps).numpy(),
                                  np.asarray(ja.get_actions(params, jnp.asarray(obs), key)))
    np.testing.assert_array_equal(
        ta.deterministic_actions(net, t_obs).numpy(),
        np.asarray(ja.get_actions(params, jnp.asarray(obs), key, stochastic=False)))
    # the warmup's indices: one randint a sub-action from fold_in(key, j)
    for j, n in enumerate(NVEC):
        noise.ints.append((n, randint(jax.random.fold_in(key, j), (BATCH,), n)))
    trand = ta.random_actions(noise, BATCH)
    np.testing.assert_array_equal(trand.numpy(), np.asarray(ja.random_actions(key, BATCH)))
    # one-hot joint actions: a Box, a Discrete and a MultiDiscrete agent
    acts = [np.random.default_rng(4).normal(size=(BATCH, 2)).astype(np.float32),
            np.random.default_rng(5).integers(0, 4, (BATCH, 1)), np.asarray(trand)]
    tsp = [spaces.Box.create(-1.0, 1.0, 2), spaces.Discrete(4), spaces.MultiDiscrete(NVEC)]
    jsp = [jspaces.Box.create(-1.0, 1.0, 2), jspaces.Discrete(4), jspaces.MultiDiscrete(NVEC)]
    _close(encode_joint_actions([torch.as_tensor(a) for a in acts], tsp),
           jencode(tuple(jnp.asarray(a) for a in acts), jsp))


@pytest.mark.parametrize("hidden", [(16, 16), (8,)])
def test_cnn_base_matches_flax(hidden):
    jbase = JCNNBase(hidden)
    x = np.random.default_rng(0).uniform(0.0, 255.0, (2, 3) + IMAGE).astype(np.float32)
    params = _perturbed(jbase.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    tbase = CNNBase(IMAGE, hidden, device="cpu")
    sd = {k[len("base."):]: v for k, v in convert._mlp_base(params["params"]).items()}
    tbase.load_state_dict(sd)
    assert tbase.conv.weight.shape == (hidden[0] // 2, IMAGE[2], 3, 3)
    _close(tbase(torch.from_numpy(x)).detach(), jbase.apply(params, jnp.asarray(x)))


def test_pixel_policy_and_vnet_match_flax():
    x = np.random.default_rng(3).uniform(0.0, 255.0, (5,) + IMAGE).astype(np.float32)
    x[x < 200.0] = 0.0                              # sparse rasters, as the soccer minimap
    jpol = JPolicy(action_space=jspaces.Discrete(19), hidden_sizes=HIDDEN, image_input=True)
    params = _perturbed(jpol.init(jax.random.PRNGKey(1), jnp.asarray(x)), 2)
    tpol = StochasticPolicy(IMAGE, spaces.Discrete(19), HIDDEN, device="cpu")
    tpol.load_state_dict(convert.policy_state_dict(params))
    (jlogits,), _ = jpol.apply(params, jnp.asarray(x))
    (tlogits,), _ = tpol(torch.from_numpy(x))
    _close(tlogits.detach(), jlogits)
    jv = JVNet(hidden_sizes=HIDDEN, image_input=True)
    vparams = _perturbed(jv.init(jax.random.PRNGKey(4), jnp.asarray(x)), 5)
    tv = VNet(IMAGE, HIDDEN, device="cpu")
    tv.load_state_dict(convert.vnet_state_dict(vparams))
    _close(tv(torch.from_numpy(x))[0].detach(), jv.apply(vparams, jnp.asarray(x))[0])
