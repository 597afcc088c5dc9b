"""The port's modules against the flax modules of the JAX package, under
weights carried across by ``sheeprl_tpu_torch.convert``.

Inputs and weights are drawn from numpy seeds.  Tolerance 1e-5,
1e-4 where convolutions sum over many terms in another order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3 import agent as jax_agent
from sheeprl_tpu.models import models as jax_models
from sheeprl_tpu.utils.distribution import OneHotCategorical as JaxOneHot
from sheeprl_tpu_torch.algos.dreamer_v3 import agent as pt_agent
from sheeprl_tpu_torch.convert import module_state_from_flax
from sheeprl_tpu_torch.models import models as pt_models
from sheeprl_tpu_torch.utils.distribution import OneHotCategorical

TOL = dict(rtol=1e-5, atol=1e-5)
CONV_TOL = dict(rtol=1e-4, atol=1e-4)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _init(module, *args, seed=0):
    """flax variables of ``module`` drawn with numpy: kernels ~ N(0, 1/fan_in),
    LayerNorm scales 1 + N(0, 0.01), everything else N(0, 0.01).  Nothing
    sits at its init value (LN scales of one and zero heads would hide layout
    errors), and only the shapes come from flax (``eval_shape``, no compile)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        noise = _rand(rng, *leaf.shape)
        if name.endswith("kernel"):
            return noise / np.sqrt(np.prod(leaf.shape[:-1]))
        return 1.0 + 0.1 * noise if name.endswith("scale") else 0.1 * noise

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _apply(module, variables, *args, method=None):
    """``module.apply`` compiled as one program: on the CPU that is an order
    of magnitude faster than dispatching the flax ops one by one."""
    return jax.jit(functools.partial(module.apply, method=method))(variables, *args)


def _load(torch_module, variables):
    torch_module.load_state_dict(module_state_from_flax(variables), strict=True)
    return torch_module.eval()


def _t(a):
    return torch.from_numpy(np.array(a))


def test_layer_norm():
    rng = np.random.default_rng(0)
    x = _rand(rng, 4, 10, scale=3.0)
    flax_ln = jax_models.LayerNorm(eps=1e-3)
    v = _init(flax_ln, x)
    out = _load(pt_models.LayerNorm(10, eps=1e-3), v)(_t(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(_apply(flax_ln, v, x)), **TOL)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["flax-layout", "use_pallas-layout"])
def test_layernorm_gru_cell(use_pallas):
    rng = np.random.default_rng(1)
    x, h = _rand(rng, 5, 12), np.tanh(_rand(rng, 5, 16))
    cell = jax_models.LayerNormGRUCell(units=16, use_pallas=use_pallas)
    v = _init(cell, h, x)
    ref, _ = _apply(cell, v, h, x)
    out, _ = _load(pt_models.LayerNormGRUCell(12, 16, use_pallas=use_pallas), v)(_t(h), _t(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)


def test_encoder_pixels_and_vector():
    rng = np.random.default_rng(2)
    obs = {"rgb": _rand(rng, 2, 3, 32, 32, 3, scale=0.5), "state": _rand(rng, 2, 3, 5, scale=4.0)}
    enc = jax_agent.Encoder(cnn_keys=("rgb",), mlp_keys=("state",), cnn_mult=4, mlp_units=16, mlp_layers=2)
    v = _init(enc, obs)
    ref = np.asarray(_apply(enc, v, obs))
    port = pt_agent.Encoder(("rgb",), ("state",), {"rgb": (32, 32, 3)}, {"state": 5}, cnn_mult=4,
                            mlp_units=16, mlp_layers=2)
    assert port.out_features == ref.shape[-1]
    out = _load(port, v)({k: _t(a) for k, a in obs.items()})
    assert out.shape == ref.shape == (2, 3, 2 * 2 * 32 + 16)
    np.testing.assert_allclose(out.detach().numpy(), ref, **CONV_TOL)


def test_decoder_transposed_convolutions():
    rng = np.random.default_rng(3)
    latent = _rand(rng, 3, 20)
    dec = jax_agent.Decoder(cnn_keys=("rgb",), mlp_keys=("state",), cnn_shapes={"rgb": (64, 64, 3)},
                            mlp_shapes={"state": 5}, cnn_mult=4, mlp_units=16, mlp_layers=2)
    v = _init(dec, latent)
    ref = _apply(dec, v, latent)
    port = _load(pt_agent.Decoder(20, ("rgb",), ("state",), {"rgb": (64, 64, 3)}, {"state": 5}, cnn_mult=4,
                                  mlp_units=16, mlp_layers=2), v)
    out = port(_t(latent))
    assert out["rgb"].shape == (3, 64, 64, 3)
    for k in ("rgb", "state"):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(ref[k]), **CONV_TOL)


LAYOUTS = {"flax": {}, "use_pallas": {"use_pallas": True}, "fused_pallas": {"fused_pallas": True}}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_recurrent_model_layouts(layout):
    rng = np.random.default_rng(4)
    x, h = _rand(rng, 5, 20), np.tanh(_rand(rng, 5, 24))
    rm = jax_agent.RecurrentModel(recurrent_size=24, dense_units=16, **LAYOUTS[layout])
    v = _init(rm, h, x)
    port = _load(pt_agent.RecurrentModel(20, 24, 16, **LAYOUTS[layout]), v)
    out = port(_t(h), _t(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(_apply(rm, v, h, x)), **TOL)


def _world_models(layout):
    kwargs = dict(
        cnn_keys=("rgb",), mlp_keys=("state",), cnn_shapes={"rgb": (64, 64, 3)}, mlp_shapes={"state": 4},
        actions_dim=(4,), cnn_mult=2, dense_units=16, mlp_layers=1, recurrent_size=16, hidden_size=16,
        repr_hidden_size=16, stochastic_size=4, discrete_size=5,
    )
    flags = {"flax": {}, "use_pallas": {"use_pallas_gru": True}, "fused_pallas": {"fused_pallas_rssm": True}}[layout]
    wm = jax_agent.WorldModel(**kwargs, **flags)
    obs = {"rgb": np.zeros((1, 64, 64, 3), np.float32), "state": np.zeros((1, 4), np.float32)}
    z = lambda *s: jnp.zeros(s)  # noqa: E731
    v = _init(wm, obs, z(1, 16), z(1, 20), z(1, 4), jnp.ones((1, 1)), jax.random.PRNGKey(1))
    port = _load(pt_agent.WorldModel(**kwargs, **flags), v)
    return wm, v, port


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_world_model_initial_state_and_posterior_step(layout):
    wm, v, port = _world_models(layout)
    rng = np.random.default_rng(5)
    B = 4
    obs = {"rgb": _rand(rng, B, 64, 64, 3, scale=0.3), "state": _rand(rng, B, 4)}
    prev_h, prev_a = np.tanh(_rand(rng, B, 16)), np.eye(4, dtype=np.float32)[[0, 1, 2, 3]]
    prev_z = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (B, 4))].reshape(B, 20)
    is_first = np.array([[1.0], [0.0], [0.0], [1.0]], np.float32)
    noise = np.asarray(JaxOneHot.sample_noise(jax.random.PRNGKey(7), (B, 4, 5)))

    h0, z0 = jax.jit(lambda v: wm.apply(v, B, method=type(wm).initial_state))(v)
    with torch.no_grad():
        ph0, pz0 = port.initial_state(B)
        embed = port.encode({k: _t(a) for k, a in obs.items()})
        got = port.dynamic_noise(_t(prev_h), _t(prev_z), _t(prev_a), embed, _t(is_first), _t(noise))
    np.testing.assert_allclose(ph0.numpy(), np.asarray(h0), **TOL)
    np.testing.assert_array_equal(pz0.numpy(), np.asarray(z0))

    jax_embed = _apply(wm, v, obs, method=type(wm).encode)
    np.testing.assert_allclose(embed.numpy(), np.asarray(jax_embed), **CONV_TOL)
    want = _apply(wm, v, prev_h, prev_z, prev_a, jax_embed, is_first, noise, method=type(wm).dynamic_noise)
    h, z, post, prior = (x.numpy() for x in got)
    np.testing.assert_allclose(h, np.asarray(want[0]), **CONV_TOL)
    np.testing.assert_array_equal(z.reshape(B, 4, 5).argmax(-1), np.asarray(want[1]).reshape(B, 4, 5).argmax(-1))
    np.testing.assert_allclose(post, np.asarray(want[2]), **CONV_TOL)
    np.testing.assert_allclose(prior, np.asarray(want[3]), **CONV_TOL)


@pytest.mark.parametrize("actions_dim,continuous", [((4, 3), False), ((2,), True)], ids=["discrete", "continuous"])
def test_actor_head_and_mode(actions_dim, continuous):
    rng = np.random.default_rng(6)
    latent = _rand(rng, 5, 24)
    actor = jax_agent.Actor(actions_dim=actions_dim, is_continuous=continuous, dense_units=16, mlp_layers=2)
    v = _init(actor, latent)
    head = np.asarray(_apply(actor, v, latent))
    port = _load(pt_agent.Actor(24, actions_dim, continuous, dense_units=16, mlp_layers=2), v)
    with torch.no_grad():
        out = port(_t(latent))
        mode = port.sample(out, torch.Generator().manual_seed(0), greedy=True)
    np.testing.assert_allclose(out.numpy(), head, **TOL)
    want = np.asarray(actor.sample(jnp.asarray(head), jax.random.PRNGKey(0), greedy=True))
    if continuous:
        np.testing.assert_allclose(mode.numpy(), want, **TOL)
    else:
        np.testing.assert_array_equal(mode.numpy(), want)


def test_one_hot_categorical_unimix_and_noise_sampling():
    rng = np.random.default_rng(8)
    logits = _rand(rng, 6, 7, scale=3.0)
    noise = np.asarray(JaxOneHot.sample_noise(jax.random.PRNGKey(3), logits.shape))
    jd, pd = JaxOneHot(jnp.asarray(logits), unimix=0.01), OneHotCategorical(_t(logits), unimix=0.01)
    np.testing.assert_allclose(pd.logits.numpy(), np.asarray(jd.logits), **TOL)
    np.testing.assert_array_equal(pd.mode().numpy(), np.asarray(jd.mode()))
    np.testing.assert_array_equal(
        pd.rsample_from_noise(_t(noise)).numpy().argmax(-1), np.asarray(jd.rsample_from_noise(noise)).argmax(-1)
    )
    np.testing.assert_allclose(pd.entropy().numpy(), np.asarray(jd.entropy()), **TOL)


def test_hafner_init_statistics():
    """Init is checked by its statistics: fan-avg truncated normal trunks
    (std sqrt(2 / (fan_in + fan_out))), zero reward/continue heads."""
    mlp = pt_agent.DreamerMLP(256, 512, 1, output_dim=255, zero_head=True)
    mlp.init_weights(torch.Generator().manual_seed(0))
    w = mlp.dense_0.weight
    assert abs(w.std().item() - (2.0 / (256 + 512)) ** 0.5) < 2e-3
    assert w.abs().max().item() <= 2 * (2.0 / (256 + 512)) ** 0.5 / 0.8796 + 1e-6
    assert mlp.head.weight.abs().max().item() == 0.0
    assert torch.all(mlp.ln_0.weight == 1) and torch.all(mlp.dense_0.bias == 0)


def test_world_model_imagination_and_heads():
    """The prior step's recurrent state (the noise only picks z) and the
    reward / continue / critic heads on the same latent."""
    wm, v, port = _world_models("fused_pallas")
    rng = np.random.default_rng(9)
    B = 3
    prev_h, action = np.tanh(_rand(rng, B, 16)), np.eye(4, dtype=np.float32)[[1, 2, 3]]
    prev_z = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (B, 4))].reshape(B, 20)
    h_jax, _ = _apply(wm, v, prev_h, prev_z, action, jax.random.PRNGKey(0), method=type(wm).imagination)
    latent = _rand(rng, B, 36)
    critic = jax_agent.Critic(dense_units=16, mlp_layers=1, bins=255)
    cv = _init(critic, latent)
    port_critic = _load(pt_agent.Critic(36, dense_units=16, mlp_layers=1, bins=255), cv)
    with torch.no_grad():
        h, z = port.imagination(_t(prev_h), _t(prev_z), _t(action), torch.Generator().manual_seed(0))
        got = (port.reward_logits(_t(latent)), port.continue_logits(_t(latent)), port_critic(_t(latent)))
    np.testing.assert_allclose(h.numpy(), np.asarray(h_jax), **TOL)
    assert z.shape == (B, 20) and torch.all(z.reshape(B, 4, 5).sum(-1).round() == 1)
    want = (_apply(wm, v, latent, method=type(wm).reward_logits),
            _apply(wm, v, latent, method=type(wm).continue_logits), _apply(critic, cv, latent))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


# -- the on-policy blocks (PPO's MultiEncoder, MLP heads) ---------------------
@pytest.mark.parametrize("layer_norm", [False, True], ids=["plain", "layer_norm"])
def test_mlp_with_head(layer_norm):
    rng = np.random.default_rng(10)
    x = _rand(rng, 5, 12)
    mlp = jax_models.MLP(hidden_sizes=(16, 8), output_dim=3, activation="tanh", layer_norm=layer_norm)
    v = _init(mlp, x)
    port = _load(pt_models.MLP(12, (16, 8), 3, activation="tanh", layer_norm=layer_norm), v)
    np.testing.assert_allclose(port(_t(x)).detach().numpy(), np.asarray(_apply(mlp, v, x)), **TOL)


@pytest.mark.parametrize("size,pads", [(84, [(1, 1), (1, 1), (1, 2)]), (64, [(1, 1), (1, 1), (1, 1)]),
                                       (21, [(1, 2), (1, 2), (1, 1)])])
def test_same_padding_matches_xla(size, pads):
    """XLA's SAME: the odd pixel goes on the high side (84 -> 42 -> 21 -> 11)."""
    got = []
    for _ in range(3):
        got.append(pt_models.same_padding(size, 4, 2))
        size = -(-size // 2)
    assert got == pads


@pytest.mark.parametrize("hw", [(84, 84), (64, 64), (21, 30)], ids=["84", "64", "21x30"])
def test_cnn_same_padding_and_nhwc_flatten(hw):
    rng = np.random.default_rng(11)
    x = _rand(rng, 2, *hw, 6, scale=0.5)
    cnn = jax_models.CNN(channels=(8, 16, 16), kernel_sizes=4, strides=2, activation="relu")
    v = _init(cnn, x)
    port = _load(pt_models.CNN((*hw, 6), (8, 16, 16), kernel_size=4, stride=2, activation="relu"), v)
    ref = np.asarray(_apply(cnn, v, x))
    out = port(_t(x)).detach().numpy()
    assert out.shape == ref.shape and port.out_features == ref.shape[-1]
    np.testing.assert_allclose(out, ref, **CONV_TOL)


@pytest.mark.parametrize("size,stack", [(84, 4), (84, 1), (64, 2)], ids=["84-stack4", "84", "64-stack2"])
def test_multi_encoder_as_ppo_builds_it(size, stack):
    """PPO's encoder: CNN 32/64/64 on the frame-stacked image (merged into
    channels by the port's ``obs_to_np``) with ``cnn_proj``, an MLP with
    LayerNorm on the vector with ``mlp_proj``."""
    from sheeprl_tpu_torch.algos.ppo.utils import obs_to_np

    rng = np.random.default_rng(12)
    raw = rng.integers(0, 256, (2, stack, size, size, 3) if stack > 1 else (2, size, size, 3), dtype=np.uint8)
    obs = {"rgb": obs_to_np(raw, is_image=True), "state": _rand(rng, 2, 5)}
    kwargs = dict(cnn_keys=("rgb",), mlp_keys=("state",), cnn_channels=(32, 64, 64), cnn_features_dim=16,
                  mlp_sizes=(8, 8), mlp_layer_norm=True, mlp_features_dim=6, activation="relu")
    enc = jax_models.MultiEncoder(**kwargs)
    v = _init(enc, obs)
    port = _load(pt_models.MultiEncoder(cnn_shapes={"rgb": (size, size, 3 * stack)}, mlp_shapes={"state": 5},
                                        **kwargs), v)
    ref = np.asarray(_apply(enc, v, obs))
    out = port({k: _t(a) for k, a in obs.items()}).detach().numpy()
    assert out.shape == ref.shape == (2, 22) and port.out_features == 22
    np.testing.assert_allclose(out, ref, **CONV_TOL)


def test_lecun_init_statistics():
    """flax's default init, checked by its statistics: fan-in truncated
    normal kernels (std 1/sqrt(fan_in), fan_in counting the receptive
    field), zero biases."""
    g = torch.Generator().manual_seed(0)
    enc = pt_models.MultiEncoder(("rgb",), (), {"rgb": (84, 84, 12)}, {}, cnn_channels=(32, 64, 64),
                                 cnn_features_dim=512, activation="relu")
    enc.init_weights(g)
    for w, fan_in in ((enc.cnn_encoder.conv_1.weight, 4 * 4 * 32), (enc.cnn_proj.weight, 11 * 11 * 64)):
        assert abs(w.std().item() * fan_in**0.5 - 1.0) < 0.05
        assert w.abs().max().item() <= 2 / 0.8796 / fan_in**0.5 + 1e-6
    assert torch.all(enc.cnn_encoder.conv_0.bias == 0) and torch.all(enc.cnn_proj.bias == 0)


# -- the off-policy blocks (SAC-AE's decoder, the stacked critic layers) ------
@pytest.mark.parametrize("hw,keys", [((64, 64), ("rgb", "state")), ((48, 32), ("rgb", "state")),
                                     ((64, 64), ("rgb",))], ids=["64-cnn+mlp", "48x32-cnn+mlp", "64-cnn"])
def test_multi_decoder_and_decnn(hw, keys):
    """SAC-AE's ``MultiDecoder``: a ``cnn_in`` stem to (h0, w0, 64) with
    ``h0 = H / 8``, ``DeCNN`` 32/16 → the two images' 5 channels (flax's
    ConvTranspose SAME, kernel 4, stride 2, its kernel flipped by
    ``convert.py``), split per key NHWC; the vector heads on an MLP trunk."""
    rng = np.random.default_rng(13)
    feats = _rand(rng, 3, 8)
    cnn_shapes = {"rgb": (*hw, 3), "depth": (*hw, 2)}
    mlp = tuple(k for k in keys if k == "state")
    kwargs = dict(cnn_keys=("rgb", "depth"), mlp_keys=mlp, cnn_shapes=cnn_shapes, mlp_shapes={"state": 5},
                  cnn_channels=(32, 16), cnn_stem_channels=64, mlp_sizes=(16, 16), activation="relu")
    dec = jax_models.MultiDecoder(**kwargs)
    v = _init(dec, feats)
    port = _load(pt_models.MultiDecoder(8, **kwargs), v)
    assert port.stem == (hw[0] // 8, hw[1] // 8, 64)
    ref = _apply(dec, v, feats)
    out = port(_t(feats))
    assert set(out) == set(ref) == {"rgb", "depth", *mlp}
    for k in ref:
        assert tuple(out[k].shape) == tuple(ref[k].shape)
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(ref[k]), **CONV_TOL, err_msg=k)
    # flipped on the way across: the kernel as flax stores it does not give flax's output
    unflipped = pt_models.MultiDecoder(8, **kwargs)
    unflipped.load_state_dict(port.state_dict())
    with torch.no_grad():
        for i in range(3):
            w = getattr(unflipped.decnn, f"deconv_{i}").weight
            w.copy_(w.flip(2, 3))
    assert not np.allclose(unflipped(_t(feats))["rgb"].detach().numpy(), np.asarray(ref["rgb"]), **CONV_TOL)


def test_decnn_supports_only_the_verified_kernel():
    with pytest.raises(ValueError, match="kernel 4, stride 2"):
        pt_models.DeCNN(4, (8,), kernel_size=3, stride=1)


def test_stacked_linear_and_layer_norm_against_vmapped_flax():
    """N dense layers as one (N, in, out) kernel, and N LayerNorms, against
    the params-vmapped flax modules they replace."""
    rng = np.random.default_rng(14)
    x = _rand(rng, 6, 5)
    dense = jax_models.nn.vmap(jax_models.nn.Dense, in_axes=None, out_axes=0, axis_size=3,
                               variable_axes={"params": 0}, split_rngs={"params": True})(7)
    v = _init(dense, x)
    port = pt_models.StackedLinear(3, 5, 7)
    port.load_state_dict(module_state_from_flax(v, stacked=True))
    hidden = np.asarray(_apply(dense, v, x))
    np.testing.assert_allclose(port(_t(x)).detach().numpy(), hidden, **TOL)
    ln = jax_models.nn.vmap(jax_models.LayerNorm, in_axes=0, out_axes=0, axis_size=3,
                            variable_axes={"params": 0}, split_rngs={"params": True})()
    lv = _init(ln, hidden)
    port_ln = pt_models.StackedLayerNorm(3, 7, eps=1e-5)
    port_ln.load_state_dict(module_state_from_flax(lv, stacked=True))
    np.testing.assert_allclose(port_ln(_t(hidden)).detach().numpy(), np.asarray(_apply(ln, lv, hidden)), **TOL)
