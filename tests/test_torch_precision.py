"""The precision policy of the port against the JAX package's, on the CPU.

``fabric.precision`` maps ``32-true`` / ``bf16-mixed`` / ``bf16-true`` to
JAX's ``(param_dtype, compute_dtype)`` table, and every module computes in
the compute dtype where its flax counterpart does, with fp32 parameters,
fp32 LayerNorm islands, fp32 heads and the kernels fed fp32 at their
wrappers.  bf16 results are never held bit for bit: the same math rounds in
other places on the two sides (flax rounds a product to bf16 before its
bias, a fused ``F.linear`` once; XLA may keep fp32 between fused
elementwise ops).  The tiers:

* a module: the output dtype equals flax's, and on the same fp32 weights
  the port's bf16 output lies no further from the fp32 output than
  ``BF16_MODULE_FACTOR`` times JAX's own bf16 error (plus 2^-8 of the
  output's largest magnitude, one bf16 ulp at the top of its range), and
  within the sum of both errors of JAX's bf16 output;
* a kernel wrapper: bf16 ``x`` and ``h`` give bit for bit what their fp32
  upcasts give (the cast is the wrapper's only change), held to JAX's op at
  the fp32 tier 1e-5;
* one train update: an update samples latents and actions by argmax over
  Gumbel-perturbed logits, so a bf16 rounding flips a sample now and then,
  and the update moves with it.  JAX itself, from weights moved by half a
  bf16 ulp (2^-9 relative), moves its DreamerV3 policy loss by up to 16%,
  its value loss by 7% and the actor's and critic's parameter changes by
  18-24% (relative L2), while its world-model losses move by at most 2.7e-3
  relative and the world model's parameter changes by 5.8e-2.  The update
  tiers (``UPDATE_TIERS``) sit above that spread.  Plan2Explore's update
  chains four such stages, and JAX's own spread there reaches 3.5e-2 on the
  world-model losses, 0.24 on the world model's changes and 1.32 on the
  task actor's: ``P2E_TIERS``.
* XLA:CPU sums the gradient of a bf16 convolution's bias in bf16: after one
  DreamerV2 update the last deconvolution's bias moves by 0.188 where the
  fp32 update moves it by 1.499 (the port's bf16 update: 1.502).  Those
  biases (DreamerV2 and V1; DreamerV3's convolutions have none) are held to
  JAX's fp32 update instead, at the same tier.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v1 import agent as jax_dv1
from sheeprl_tpu.algos.dreamer_v1.dreamer_v1 import make_train_phase as jax_dv1_phase
from sheeprl_tpu.algos.dreamer_v2 import dreamer_v2 as jax_dv2
from sheeprl_tpu.algos.dreamer_v3 import agent as jax_agent
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import build_dv3_optimizers as jax_dv3_opts
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_train_phase as jax_dv3_phase
from sheeprl_tpu.algos.p2e_dv3 import p2e_dv3_exploration as jax_p2e
from sheeprl_tpu.config.compose import compose as jax_compose
from sheeprl_tpu.models import models as jax_models
from sheeprl_tpu.ops.gru_pallas import fused_layernorm_gru as jax_gru
from sheeprl_tpu.ops.rssm_pallas import fused_rssm_recurrent as jax_rssm
from sheeprl_tpu.parallel.fabric import Precision as JaxPrecision
from sheeprl_tpu.parallel.fabric import build_fabric as jax_build_fabric
from sheeprl_tpu.serve.loader import probe_spaces as jax_probe_spaces
from sheeprl_tpu.serve.players import build_dreamer_v3_player as jax_player
from sheeprl_tpu.utils.distribution import OneHotCategorical as JaxOneHot
from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent as dv1_build_agent
from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import DV1Trainer
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import DV2Trainer
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import build_agent as dv2_build_agent
from sheeprl_tpu_torch.algos.dreamer_v3 import agent as pt_agent
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer, build_dv3_optimizers
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import P2EDV3Trainer
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import build_agent as p2e_build_agent
from sheeprl_tpu_torch.algos.p2e_utils import p2e_optimizers
from sheeprl_tpu_torch.config.compose import compose
from sheeprl_tpu_torch.convert import agent_state_from_jax, module_state_from_flax
from sheeprl_tpu_torch.fabric import Precision, build_fabric
from sheeprl_tpu_torch.models import models as pt_models
from sheeprl_tpu_torch.ops.gru import fused_layernorm_gru
from sheeprl_tpu_torch.ops.rssm import fused_rssm_recurrent
from sheeprl_tpu_torch.serve.loader import probe_spaces
from sheeprl_tpu_torch.serve.players import build_dreamer_v3_player
from tests.test_torch_serve import TINY as SERVE_TINY
from tests.test_torch_serve import _jax_params
from tests.test_torch_train_step import B, H, L, family_run, sgd_overrides

BF16 = torch.bfloat16
JBF16 = jnp.bfloat16
BF16_MODULE_FACTOR = 2.0
BF16_ULP = 2.0 ** -8


# -- the policy ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["32-true", "bf16-mixed", "bf16-true"])
def test_precision_table_is_jax_table(name):
    ref, ours = JaxPrecision.from_string(name), Precision.from_string(name)
    assert ours.name == name
    assert ours.param_dtype == getattr(torch, jnp.dtype(ref.param_dtype).name)
    assert ours.compute_dtype == getattr(torch, jnp.dtype(ref.compute_dtype).name)
    fabric = build_fabric(compose([*SERVE_TINY, f"fabric.precision={name}"]))
    assert fabric.precision == ours
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    if name != "32-true":
        assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction


# -- modules -------------------------------------------------------------------------
def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _init(module, *args, seed=0):
    """flax variables drawn with numpy (kernels ~ N(0, 1/fan_in), LN scales
    near one, the rest small); shapes from ``eval_shape``."""
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
    return jax.jit(functools.partial(module.apply, method=method))(variables, *args)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _leaves(out):
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    if isinstance(out, (tuple, list)):
        return list(out)
    return [out]


def _hold(port_bf16, jax_bf16, jax_f32):
    """The module tier of the docstring, output by output."""
    for p, j, ref in zip(_leaves(port_bf16), _leaves(jax_bf16), _leaves(jax_f32)):
        assert str(p.dtype) == f"torch.{jnp.dtype(j.dtype).name}", (p.dtype, j.dtype)
        p = p.detach().float().numpy()
        j, ref = np.asarray(jnp.asarray(j, jnp.float32)), np.asarray(ref, np.float32)
        ulp = BF16_ULP * np.abs(ref).max()
        jax_err, port_err = np.abs(j - ref).max(), np.abs(p - ref).max()
        assert port_err <= BF16_MODULE_FACTOR * jax_err + ulp, (port_err, jax_err)
        assert np.abs(p - j).max() <= port_err + jax_err + ulp


def _module_case(flax_cls, torch_fn, args, method=None, **flax_kw):
    """One flax module at fp32 and at bf16 on one numpy-drawn tree, and the
    port's module at bf16 on the same tree."""
    f32, bf = flax_cls(**flax_kw, dtype=jnp.float32), flax_cls(**flax_kw, dtype=JBF16)
    v = _init(f32, *args)
    port = torch_fn(BF16)
    port.load_state_dict(module_state_from_flax(v), strict=True)
    with torch.no_grad():
        got = port(*(({k: _t(a) for k, a in x.items()} if isinstance(x, dict) else _t(x)) for x in args))
    return got, _apply(bf, v, *args, method=method), _apply(f32, v, *args, method=method)


def _mods():
    rng = np.random.default_rng(0)
    x12, x6x12 = _rand(rng, 6, 12, scale=2.0), _rand(rng, 6, 12)
    h16, x_gru = np.tanh(_rand(rng, 5, 16)), _rand(rng, 5, 12)
    img = _rand(rng, 2, 16, 16, 3, scale=0.5)
    obs = {"rgb": _rand(rng, 2, 3, 32, 32, 3, scale=0.5), "state": _rand(rng, 2, 3, 5, scale=4.0)}
    latent = _rand(rng, 3, 20)
    x_rm, h_rm = _rand(rng, 5, 20), np.tanh(_rand(rng, 5, 24))
    ppo_obs = {"rgb": _rand(rng, 4, 16, 16, 3, scale=0.5), "state": _rand(rng, 4, 5)}
    feats = _rand(rng, 4, 10)
    return {
        "LayerNorm": (jax_models.LayerNorm, lambda d: pt_models.LayerNorm(12, eps=1e-3, dtype=d), (x12,),
                      dict(eps=1e-3)),
        "MLP": (jax_models.MLP, lambda d: pt_models.MLP(12, (16, 16), 5, layer_norm=True, dtype=d), (x6x12,),
                dict(hidden_sizes=(16, 16), output_dim=5, layer_norm=True)),
        "CNN": (jax_models.CNN, lambda d: pt_models.CNN((16, 16, 3), (4, 8), kernel_size=4, stride=2, dtype=d),
                (img,), dict(channels=(4, 8), kernel_sizes=4, strides=2)),
        "DeCNN": (jax_models.DeCNN, lambda d: pt_models.DeCNN(3, (4, 2), dtype=d), (img,),
                  dict(channels=(4, 2), kernel_sizes=4, strides=2)),
        "MultiEncoder": (jax_models.MultiEncoder,
                         lambda d: pt_models.MultiEncoder(("rgb",), ("state",), {"rgb": (16, 16, 3)}, {"state": 5},
                                                          cnn_channels=(4, 8), cnn_features_dim=12, mlp_sizes=(8,),
                                                          mlp_features_dim=6, activation="relu", dtype=d),
                         (ppo_obs,), dict(cnn_keys=("rgb",), mlp_keys=("state",), cnn_channels=(4, 8),
                                          cnn_features_dim=12, mlp_sizes=(8,), mlp_features_dim=6,
                                          activation="relu")),
        "MultiDecoder": (jax_models.MultiDecoder,
                         lambda d: pt_models.MultiDecoder(10, ("rgb",), ("state",), {"rgb": (16, 16, 3)}, {"state": 5},
                                                          cnn_channels=(8, 4), cnn_stem_channels=8, mlp_sizes=(8,),
                                                          dtype=d),
                         (feats,), dict(cnn_keys=("rgb",), mlp_keys=("state",), cnn_shapes={"rgb": (16, 16, 3)},
                                        mlp_shapes={"state": 5}, cnn_channels=(8, 4), cnn_stem_channels=8,
                                        mlp_sizes=(8,))),
        "LayerNormGRUCell": (jax_models.LayerNormGRUCell, lambda d: pt_models.LayerNormGRUCell(12, 16, dtype=d),
                             (h16, x_gru), dict(units=16)),
        "LayerNormGRUCell-use_pallas": (jax_models.LayerNormGRUCell,
                                        lambda d: pt_models.LayerNormGRUCell(12, 16, use_pallas=True, dtype=d),
                                        (h16, x_gru), dict(units=16, use_pallas=True)),
        "DreamerMLP-head": (jax_agent.DreamerMLP, lambda d: pt_agent.DreamerMLP(12, 16, 2, output_dim=7, dtype=d),
                            (x6x12,), dict(units=16, layers=2, output_dim=7)),
        "Encoder": (jax_agent.Encoder,
                    lambda d: pt_agent.Encoder(("rgb",), ("state",), {"rgb": (32, 32, 3)}, {"state": 5}, cnn_mult=4,
                                               mlp_units=16, mlp_layers=2, dtype=d),
                    (obs,), dict(cnn_keys=("rgb",), mlp_keys=("state",), cnn_mult=4, mlp_units=16, mlp_layers=2)),
        "Decoder": (jax_agent.Decoder,
                    lambda d: pt_agent.Decoder(20, ("rgb",), ("state",), {"rgb": (64, 64, 3)}, {"state": 5},
                                               cnn_mult=4, mlp_units=16, mlp_layers=2, dtype=d),
                    (latent,), dict(cnn_keys=("rgb",), mlp_keys=("state",), cnn_shapes={"rgb": (64, 64, 3)},
                                    mlp_shapes={"state": 5}, cnn_mult=4, mlp_units=16, mlp_layers=2)),
        "RecurrentModel": (jax_agent.RecurrentModel, lambda d: pt_agent.RecurrentModel(20, 24, 16, dtype=d),
                           (h_rm, x_rm), dict(recurrent_size=24, dense_units=16)),
        "RecurrentModel-use_pallas": (jax_agent.RecurrentModel,
                                      lambda d: pt_agent.RecurrentModel(20, 24, 16, use_pallas=True, dtype=d),
                                      (h_rm, x_rm), dict(recurrent_size=24, dense_units=16, use_pallas=True)),
        "RecurrentModel-fused_pallas": (jax_agent.RecurrentModel,
                                        lambda d: pt_agent.RecurrentModel(20, 24, 16, fused_pallas=True, dtype=d),
                                        (h_rm, x_rm), dict(recurrent_size=24, dense_units=16, fused_pallas=True)),
        "Critic-head": (jax_agent.Critic, lambda d: pt_agent.Critic(20, dense_units=16, mlp_layers=2, bins=9, dtype=d),
                        (latent,), dict(dense_units=16, mlp_layers=2, bins=9)),
    }


MODULES = _mods()


@pytest.mark.parametrize("name", list(MODULES))
def test_module_in_bf16_against_flax(name):
    flax_cls, torch_fn, args, kw = MODULES[name]
    got, want, ref = _module_case(flax_cls, torch_fn, args, **kw)
    if name.startswith("LayerNormGRUCell"):
        got, want, ref = got[0], want[0], ref[0]
    _hold(got, want, ref)
    if name.endswith("-head") or name == "Decoder":
        # the heads (and the decoder's last deconvolution) stay fp32, as in JAX
        assert all(t.dtype == torch.float32 for t in _leaves(got))
    elif name != "MultiDecoder":
        assert all(t.dtype == BF16 for t in _leaves(got))


def test_stacked_linear_and_layer_norm_in_bf16():
    """The stacked (ensemble) layers against the params-vmapped flax Dense
    and LayerNorm, at bf16 compute."""
    rng = np.random.default_rng(3)
    x = _rand(rng, 6, 10)

    def stacked(dtype):
        class Net(jax_models.nn.Module):
            @jax_models.nn.compact
            def __call__(self, x):
                dense = jax_models.nn.vmap(jax_models.nn.Dense, in_axes=None, out_axes=0, axis_size=3,
                                           variable_axes={"params": 0}, split_rngs={"params": True})
                y = dense(8, dtype=dtype, name="dense")(x)
                ln = jax_models.nn.vmap(jax_models.LayerNorm, in_axes=0, out_axes=0, axis_size=3,
                                        variable_axes={"params": 0}, split_rngs={"params": True})
                return ln(dtype=dtype, name="ln")(y)

        return Net()

    v = _init(stacked(jnp.float32), x)
    lin, ln = pt_models.StackedLinear(3, 10, 8, dtype=BF16), pt_models.StackedLayerNorm(3, 8, dtype=BF16)
    p = v["params"]
    with torch.no_grad():
        lin.kernel.copy_(_t(p["dense"]["kernel"]))
        lin.bias.copy_(_t(p["dense"]["bias"]))
        ln.weight.copy_(_t(p["ln"]["LayerNorm_0"]["scale"]))
        ln.bias.copy_(_t(p["ln"]["LayerNorm_0"]["bias"]))
        got = ln(lin(_t(x)))
    _hold(got, _apply(stacked(JBF16), v, x), _apply(stacked(jnp.float32), v, x))


# -- the kernels' wrappers ----------------------------------------------------------------
def _rssm_weights(rng, za, D, Hs):
    return (_rand(rng, za, D) / np.sqrt(za), 0.1 * _rand(rng, D), 1 + 0.1 * _rand(rng, D), 0.1 * _rand(rng, D),
            _rand(rng, D + Hs, 3 * Hs) / np.sqrt(D + Hs), 1 + 0.1 * _rand(rng, 3 * Hs), 0.1 * _rand(rng, 3 * Hs))


@pytest.mark.parametrize("op", ["rssm", "gru"])
def test_kernel_wrappers_cast_bf16_operands_to_fp32(op):
    """bf16 ``x`` and ``h`` give what their fp32 upcasts give, bit for bit;
    the result is fp32 and held to JAX's op (run on the CPU as its tests run
    it, in interpret mode) at the fp32 tier; the gradient of a bf16 input
    comes back in bf16 through the cast."""
    rng = np.random.default_rng(4)
    Bk, za, D, Hs = 5, 20, 16, 24
    x = torch.from_numpy(_rand(rng, Bk, za if op == "rssm" else D)).to(BF16)
    h = torch.tanh(torch.from_numpy(_rand(rng, Bk, Hs))).to(BF16)
    if op == "rssm":
        w = [_t(a) for a in _rssm_weights(rng, za, D, Hs)]
        fn, ref = fused_rssm_recurrent, jax_rssm
    else:
        w = [_t(_rand(rng, D + Hs, 3 * Hs) / np.sqrt(D + Hs)), _t(1 + 0.1 * _rand(rng, 3 * Hs)),
             _t(0.1 * _rand(rng, 3 * Hs))]
        fn, ref = fused_layernorm_gru, jax_gru
    out = fn(x, h, *w)
    assert out.dtype == torch.float32
    assert torch.equal(out, fn(x.float(), h.float(), *w))
    want = ref(jnp.asarray(x.float().numpy(), JBF16), jnp.asarray(h.float().numpy(), JBF16),
               *(jnp.asarray(t.numpy()) for t in w), interpret=True)
    assert want.dtype == jnp.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    xg = x.clone().requires_grad_(True)
    fn(xg, h, *w).sum().backward()
    assert xg.grad.dtype == BF16 and torch.isfinite(xg.grad.float()).all()


# -- DreamerV3: the posterior and imagination steps ---------------------------------------
LAYOUT_FLAGS = {"flags-off": {}, "use_pallas": {"use_pallas_gru": True}, "fused_pallas": {"fused_pallas_rssm": True}}


@pytest.mark.parametrize("layout", list(LAYOUT_FLAGS))
def test_dv3_steps_carry_fp32_state_in_bf16(layout):
    """``dynamic`` and ``imagination`` under bf16: the recurrent state comes
    back fp32 (rounded to bf16 once per step and carried in fp32, as JAX
    carries it), within the module tier of JAX's."""
    kwargs = dict(cnn_keys=(), mlp_keys=("state",), cnn_shapes={}, mlp_shapes={"state": 4}, actions_dim=(2,),
                  cnn_mult=2, dense_units=16, mlp_layers=1, recurrent_size=16, hidden_size=16,
                  repr_hidden_size=16, stochastic_size=4, discrete_size=5, **LAYOUT_FLAGS[layout])
    rng = np.random.default_rng(5)
    Bw = 6
    obs = {"state": _rand(rng, Bw, 4)}
    prev_h, action = np.tanh(_rand(rng, Bw, 16)), np.tanh(_rand(rng, Bw, 2))
    prev_z = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (Bw, 4))].reshape(Bw, 20)
    is_first = (rng.random((Bw, 1)) < 0.3).astype(np.float32)
    noise = np.asarray(JaxOneHot.sample_noise(jax.random.PRNGKey(7), (Bw, 4, 5)))
    z0 = jnp.zeros
    wm32, wmbf = jax_agent.WorldModel(**kwargs), jax_agent.WorldModel(**kwargs, dtype=JBF16)
    v = _init(wm32, {k: a[:1] for k, a in obs.items()}, z0((1, 16)), z0((1, 20)), z0((1, 2)), jnp.ones((1, 1)),
              jax.random.PRNGKey(1))
    port = pt_agent.WorldModel(**kwargs, dtype=BF16)
    port.load_state_dict(module_state_from_flax(v), strict=True)
    with torch.no_grad():
        embed = port.encode({k: _t(a) for k, a in obs.items()})
        h, z, post, prior = port.dynamic_noise(_t(prev_h), _t(prev_z), _t(action), embed, _t(is_first), _t(noise))
        h_img, _ = port.imagination_noise(_t(prev_h), _t(prev_z), _t(action), _t(noise))
    assert embed.dtype == BF16 and h.dtype == h_img.dtype == post.dtype == prior.dtype == torch.float32
    # the state is a bf16 value carried in fp32
    assert torch.equal(h, h.to(BF16).float()) and torch.equal(h_img, h_img.to(BF16).float())
    outs = {}
    for tag, wm in (("bf16", wmbf), ("f32", wm32)):
        e = _apply(wm, v, obs, method=jax_agent.WorldModel.encode)
        d = _apply(wm, v, prev_h, prev_z, action, e, is_first, noise, method=jax_agent.WorldModel.dynamic_noise)
        i = _apply(wm, v, prev_h, prev_z, action, jax.random.PRNGKey(0), method=jax_agent.WorldModel.imagination)
        outs[tag] = (e, d[0], d[2], d[3], i[0])
    assert outs["bf16"][1].dtype == outs["bf16"][4].dtype == jnp.float32
    _hold((embed, h, post, prior, h_img), outs["bf16"], outs["f32"])


# -- one update of each Dreamer ------------------------------------------------------------
TINY = (
    "env=dummy", "env.sync_env=True",
    "fabric.accelerator=cpu",
    "fabric.precision=bf16-mixed",
    "algo.world_model.encoder.cnn_channels_multiplier=2",
    "algo.dense_units=16",
    "algo.mlp_layers=1",
    "algo.world_model.recurrent_model.recurrent_state_size=16",
    "algo.world_model.transition_model.hidden_size=16",
    "algo.world_model.representation_model.hidden_size=16",
    "algo.world_model.stochastic_size=4",
    "algo.world_model.discrete_size=5",
    f"algo.per_rank_batch_size={B}",
    f"algo.per_rank_sequence_length={L}",
    f"algo.horizon={H}",
)
# the ten metrics: world model, observation, reward, KL loss, continue, KL,
# policy, value, posterior and prior entropies
WM_METRICS = [0, 1, 2, 3, 4, 5, 8, 9]
UPDATE_TIERS = {"wm_metric_rel": 5e-2, "behaviour_metric_rel": 0.35, "behaviour_metric_abs": 5e-2,
                "world_model_l2": 0.25, "behaviour_l2": 0.6, "target_l2": 1e-2}
P2E_TIERS = {**UPDATE_TIERS, "wm_metric_rel": 7e-2, "behaviour_metric_rel": 1.0, "behaviour_metric_abs": 1.0,
             "world_model_l2": 0.5, "behaviour_l2": 2.5}
CONV_BIAS = re.compile(r"\.(de)?conv_\d+\.bias$")


def _keys(pixels):
    return ["algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]"] if pixels else [
        "algo.cnn_keys.encoder=[]", "algo.mlp_keys.encoder=[state]"]


def _hold_update(trainer, j_metrics, p_metrics, start, after, after32=None, tiers=UPDATE_TIERS):
    """The update tiers of the docstring (``after32``: JAX's fp32 update from
    the same tree, the reference of the convolutions' biases); every trained
    tensor and the optimizer state stay fp32."""
    from tests.test_torch_train_step import _flat_states

    assert np.isfinite(p_metrics).all()
    rel = np.abs(p_metrics - j_metrics) / np.maximum(np.abs(j_metrics), 1e-6)
    assert (rel[WM_METRICS] <= tiers["wm_metric_rel"]).all(), rel
    behaviour = np.abs(p_metrics - j_metrics)[6:8]
    assert (behaviour <= tiers["behaviour_metric_rel"] * np.abs(j_metrics[6:8])
            + tiers["behaviour_metric_abs"]).all(), (p_metrics[6:8], j_metrics[6:8])
    ported = dict(_flat_states(trainer.agent_state()))
    groups = {}
    for path, j_after in after.items():
        assert ported[path].dtype == torch.float32, path
        if "moments" in path:
            continue
        if after32 is not None and CONV_BIAS.search(path):
            j_after = after32[path]
        top = path.split("/", 1)[0]
        group = "world_model_l2" if top == "world_model" else "target_l2" if "target" in path else "behaviour_l2"
        if top == "ensembles":
            group = "world_model_l2"
        jd = (j_after - start[path]).double()
        pd = (ported[path].detach() - start[path]).double()
        num, den = groups.get((group, top), (0.0, 0.0))
        groups[group, top] = (num + float(((pd - jd) ** 2).sum()), den + float((jd ** 2).sum()))
    for (group, top), (num, den) in groups.items():
        assert np.sqrt(num / max(den, 1e-30)) <= tiers[group], (top, np.sqrt(num / max(den, 1e-30)))
    for opt in trainer.optimizers.values():
        for st in opt.optimizer.state.values():
            assert all(v.dtype == torch.float32 for v in st.values() if torch.is_tensor(v) and v.is_floating_point())


DV3_UPDATES = {
    # id: (env, pixels, kernel flag, U)
    "fused_pallas": ("discrete_dummy", True, "fused_pallas", 1),
    "use_pallas": ("multidiscrete_dummy", False, "use_pallas", 1),
    "flags-off": ("continuous_dummy", False, None, 1),
}


@pytest.mark.parametrize("case", list(DV3_UPDATES))
def test_dv3_update_in_bf16_against_jax(case):
    env_id, pixels, flag, U = DV3_UPDATES[case]
    flags = [f"algo.world_model.recurrent_model.{flag}=True"] if flag else []
    overrides = ["exp=dreamer_v3", "algo=dreamer_v3_XS", *TINY, f"env.id={env_id}", *_keys(pixels), *flags,
                 *sgd_overrides()]
    run = family_run(jax_agent, jax_dv3_phase, jax_dv3_opts, pt_agent.build_agent, DV3Trainer, build_dv3_optimizers,
                     overrides, pixels, U, 0, n_split=2, rollouts=(1,))
    assert run[0].world_model.encoder.compute_dtype == BF16
    _hold_update(run[0], *run[2:])


FAMILY_UPDATES = {
    # id: JAX agent module, phase and optimizers; the port's builder, trainer
    # and optimizers; the exp; the SGD groups; the split chain; Gaussian
    # latents; conv biases (held to JAX's fp32 update)
    "p2e_dv3": (jax_p2e, jax_p2e.make_train_phase, jax_p2e.build_p2e_optimizers, p2e_build_agent, P2EDV3Trainer,
                p2e_optimizers, ("exp=p2e_dv3_exploration", "algo.world_model.recurrent_model.fused_pallas=True"),
                ("world_model", "actor", "critic", "ensembles"), 4, (2, 3), False, False),
    "dreamer_v2": (jax_dv2, jax_dv2.make_train_phase, jax_dv3_opts, dv2_build_agent, DV2Trainer, build_dv3_optimizers,
                   ("exp=dreamer_v2",), ("world_model", "actor", "critic"), 3, (1,), False, True),
    "dreamer_v1": (jax_dv1, jax_dv1_phase, jax_dv3_opts, dv1_build_agent, DV1Trainer, build_dv3_optimizers,
                   ("exp=dreamer_v1",), ("world_model", "actor", "critic"), 3, (1,), True, True),
}


@pytest.mark.parametrize("family", list(FAMILY_UPDATES))
def test_dreamer_family_update_in_bf16_against_jax(family):
    (jmod, jphase, jopts, pbuild, ptrainer, popts, exp, groups, n_split, rollouts, gaussian,
     conv_bias) = FAMILY_UPDATES[family]
    overrides = [*exp, *TINY, "env.id=discrete_dummy", *_keys(True), *sgd_overrides(groups)]

    def once(ov):
        return family_run(jmod, jphase, jopts, pbuild, ptrainer, popts, ov, True, 1, 0, n_split=n_split,
                          rollouts=rollouts, gaussian=gaussian)

    run = once(overrides)
    assert run[0].world_model.encoder.compute_dtype == BF16
    after32 = None
    if conv_bias:
        run32 = once([*overrides, "fabric.precision=32-true"])
        assert all(torch.equal(run32[4][k], v) for k, v in run[4].items())
        after32 = run32[5]
    _hold_update(run[0], *run[2:], after32=after32, tiers=P2E_TIERS if family == "p2e_dv3" else UPDATE_TIERS)


# -- the served DreamerV3 step -------------------------------------------------------------
@pytest.mark.parametrize("flags", [(), ("algo.world_model.recurrent_model.fused_pallas=True",)],
                         ids=["flags-off", "fused_pallas"])
def test_served_dv3_step_in_bf16_against_jax_player(flags):
    """Both players on one fp32 tree under ``bf16-mixed``, three greedy
    steps: the carried ``h`` fp32 and within the module tier of JAX's, the
    latent samples and actions equal."""
    overrides = [*SERVE_TINY, "fabric.precision=bf16-mixed", *flags]
    jcfg, pcfg = jax_compose(overrides), compose(overrides)
    jfabric, pfabric = jax_build_fabric(jcfg), build_fabric(pcfg)
    f32cfg = jax_compose([*SERVE_TINY, *flags])
    obs_space, action_space = jax_probe_spaces(jcfg)
    params = _jax_params(jcfg, jfabric, obs_space, action_space)
    jp = jax_player(jfabric, jcfg, {"agent": params}, obs_space, action_space)
    jp32 = jax_player(jax_build_fabric(f32cfg), f32cfg, {"agent": params}, obs_space, action_space)
    p_obs, p_act = probe_spaces(pcfg)
    pp = build_dreamer_v3_player(pfabric, pcfg, {"agent": agent_state_from_jax(params, pcfg)}, p_obs, p_act)
    assert pp.params["world_model"].recurrent_model.compute_dtype == BF16
    Bs, rng = 3, np.random.default_rng(0)
    greedy = np.ones((Bs,), bool)
    j_carry, j32_carry = jp.zero_carry(Bs), jp32.zero_carry(Bs)
    p_carry = tuple(torch.zeros(Bs, *s) for s, _ in pp.carry_spec)
    stoch, discrete = pcfg.algo.world_model.stochastic_size, pcfg.algo.world_model.discrete_size
    for step in range(3):
        raw = {"rgb": rng.integers(0, 256, (Bs, 64, 64, 3), dtype=np.uint8),
               "state": rng.standard_normal((Bs, 4)).astype(np.float32)}
        seed = 100 + step
        # the fp32 player is fed the bf16 player's carry: its h is the reference of this step
        j32_carry, _ = jp32.step_batch(jp32.params, j_carry, jp32.prepare(raw), seed, greedy)
        j_carry, j_actions = jp.step_batch(jp.params, j_carry, jp.prepare(raw), seed, greedy)
        k_repr, _ = jax.random.split(jax.random.PRNGKey(seed))
        noise = torch.from_numpy(np.array(JaxOneHot.sample_noise(k_repr, (Bs, stoch, discrete))))
        obs = {k: torch.from_numpy(v) for k, v in pp.prepare(raw).items()}
        with torch.no_grad():
            p_carry, p_actions = pp.step(pp.params, p_carry, obs, seed, torch.from_numpy(greedy), post_noise=noise)
        assert p_carry[0].dtype == torch.float32
        _hold(p_carry[0], jnp.asarray(j_carry[0]), j32_carry[0])
        np.testing.assert_array_equal(p_carry[1].numpy().reshape(Bs, stoch, discrete).argmax(-1),
                                      j_carry[1].reshape(Bs, stoch, discrete).argmax(-1))
        np.testing.assert_array_equal(pp.postprocess(p_actions.numpy()), jp.postprocess(j_actions))
        p_carry = tuple(torch.from_numpy(np.array(c)) for c in j_carry)  # both sides step from JAX's carry


# -- bf16-true -------------------------------------------------------------------------------
def test_bf16_true_keeps_fp32_parameters_in_both_packages():
    """No JAX module reads ``param_dtype``: under ``bf16-true`` both packages
    keep fp32 parameters (and the port fp32 optimizer state) and compute in
    bf16, as under ``bf16-mixed``."""
    overrides = ["exp=dreamer_v3", "algo=dreamer_v3_XS", *TINY, "fabric.precision=bf16-true",
                 "env.id=discrete_dummy", *_keys(False)]
    jcfg, pcfg = jax_compose(overrides), compose(overrides)
    jfabric, pfabric = jax_build_fabric(jcfg), build_fabric(pcfg)
    assert jfabric.precision.param_dtype == jnp.bfloat16 and pfabric.precision.param_dtype == BF16
    obs_space, action_space = jax_probe_spaces(jcfg)
    from sheeprl_tpu.algos.ppo.utils import spaces_to_dims

    dims, cont = spaces_to_dims(action_space)
    tree = jax.eval_shape(lambda: jax_agent.build_agent(jfabric, dims, cont, jcfg, obs_space)[3])
    assert {leaf.dtype for leaf in jax.tree_util.tree_leaves(tree)} == {jnp.dtype(jnp.float32)}
    modules = pt_agent.build_agent(pfabric, dims, cont, pcfg, probe_spaces(pcfg)[0])
    assert {p.dtype for m in modules.values() for p in m.parameters()} == {torch.float32}
    assert modules["world_model"].encoder.compute_dtype == modules["actor"].trunk.compute_dtype == BF16


# -- the on-policy and off-policy families ------------------------------------------------
# One train phase of each family under bf16-mixed against JAX's, every group
# stepped with SGD (lr 0.05; 0.01 for PPO, whose continuous head at 0.05 moves
# its losses by 70% between fp32 and bf16 on either side): a parameter's
# change is lr x its gradient, so a rounding shows in it directly (Adam would
# turn a near-zero gradient of either sign into a full step).  These phases redraw no sample (the rollout's actions
# and the update noise are given), so only rounding separates the two sides:
# measured 0.2-1.9e-2 relative L2 on the changes and up to 7e-3 relative on
# the losses.
FAMILY_TIER = {"loss_rel": 3e-2, "loss_abs": 1e-3, "change_l2": 0.1}
ONP_SGD = ("fabric.precision=bf16-mixed", "algo.optimizer.name=sgd", "algo.optimizer.lr=0.01",
           "algo.optimizer.momentum=0.0")
OFP_SGD = ("fabric.precision=bf16-mixed", *(f"algo.{g}.optimizer.{k}={v}" for g in ("actor", "critic", "alpha")
                                            for k, v in (("name", "sgd"), ("lr", 0.05), ("momentum", 0.0))))


def _hold_family(start, after, ported, losses, want_losses):
    """The family tier over every trained tensor (flat port state dicts),
    grouped by top module; every tensor stays fp32."""
    got, want = np.array([float(x) for x in losses]), np.array([float(x) for x in want_losses])
    assert np.isfinite(got).all()
    assert np.all(np.abs(got - want) <= FAMILY_TIER["loss_rel"] * np.abs(want) + FAMILY_TIER["loss_abs"]), (got, want)
    groups = {}
    for k, j_after in after.items():
        assert ported[k].dtype == torch.float32, k
        jd = (j_after - start[k]).double()
        pd = (ported[k].detach() - start[k]).double()
        num, den = groups.get(k.split(".")[0], (0.0, 0.0))
        groups[k.split(".")[0]] = (num + float(((pd - jd) ** 2).sum()), den + float((jd ** 2).sum()))
    for top, (num, den) in groups.items():
        if den > 0:
            assert np.sqrt(num / den) <= FAMILY_TIER["change_l2"], (top, np.sqrt(num / den))


def test_ppo_train_phase_in_bf16_against_jax(tmp_path, monkeypatch):
    """On vectors: with pixels JAX's bf16 phase moves off its fp32 phase by
    8% on the entropy loss (the CNN's bias gradients, summed in bf16 by
    XLA:CPU, see the docstring), where the port's moves by 2.5%."""
    import tests.test_torch_ppo as t
    from sheeprl_tpu.algos.ppo import agent as jax_ppo
    from sheeprl_tpu.algos.ppo.ppo import epoch_permutation as jax_perm
    from sheeprl_tpu.algos.ppo.ppo import main as jax_main
    from sheeprl_tpu.algos.ppo.utils import spaces_to_dims
    from sheeprl_tpu.utils.optim import build_optimizer as jax_opt
    from sheeprl_tpu_torch.algos.ppo.ppo import PPOTrainer
    from sheeprl_tpu_torch.convert import policy_state_from_jax

    overrides = (*t.BASE, *t.TRAIN_CASES["continuous"], *ONP_SGD)
    jfn, jcfg, jfabric, obs_space, act_space = t.capture_jax_train_phase(jax_main, overrides, tmp_path, monkeypatch)
    dims, cont = spaces_to_dims(act_space)
    cnn, mlp = tuple(jcfg.algo.cnn_keys.encoder), tuple(jcfg.algo.mlp_keys.encoder)
    agent, init = jax_ppo.build_agent(jfabric, dims, cont, jcfg, obs_space)
    params = t.draw_params(init)
    rollout, last_obs, rng = t.rollout_from_seed(3, obs_space, cnn + mlp, cnn, dims, cont, t.T, t.B)
    out, _ = jax.jit(agent.apply)(params, {k: rollout[k].reshape(t.T * t.B, *rollout[k].shape[2:]) for k in cnn + mlp})
    lp, _ = jax_ppo.evaluate_actions(out, rollout["actions"].reshape(t.T * t.B, -1), dims, cont, "auto")
    rollout["logprobs"] = (np.asarray(lp).reshape(t.T, t.B) + 0.3 * rng.standard_normal((t.T, t.B))).astype(np.float32)
    key = jax.random.PRNGKey(11)
    optimizer = jax_opt(jcfg.algo.optimizer, jcfg.algo.max_grad_norm)
    new_params, _, want = jfn(params, optimizer.init(params), rollout, last_obs, key, jnp.float32(0.2),
                              jnp.float32(0.01), batch_size=8, num_minibatches=2)
    perms = [torch.from_numpy(np.array(jax_perm(k, t.T, t.B, 8, 2, False, 1)))
             for k in jax.random.split(key, int(jcfg.algo.update_epochs))]
    trainer, _ = t.port_trainer(overrides, params, PPOTrainer, dims, cont, obs_space, t.T, t.B)
    assert trainer.agent.feature_extractor.mlp_encoder.compute_dtype == BF16
    got = trainer.train_phase({k: _t(v) for k, v in rollout.items()}, {k: _t(v) for k, v in last_obs.items()},
                              perms, 0.2, 0.01)
    _hold_family(policy_state_from_jax(jax.device_get(params)), policy_state_from_jax(jax.device_get(new_params)),
                 trainer.agent.state_dict(), got, want)


def test_a2c_update_in_bf16_against_jax(tmp_path, monkeypatch):
    import tests.test_torch_a2c as t
    from tests.test_torch_ppo import capture_jax_train_phase, draw_params, port_trainer, rollout_from_seed
    from sheeprl_tpu.algos.a2c.a2c import main as jax_main
    from sheeprl_tpu.algos.ppo import agent as jax_ppo
    from sheeprl_tpu.algos.ppo.utils import spaces_to_dims
    from sheeprl_tpu.utils.optim import build_optimizer as jax_opt
    from sheeprl_tpu_torch.algos.a2c.a2c import A2CTrainer
    from sheeprl_tpu_torch.convert import policy_state_from_jax

    overrides = (*t.BASE, *t.ENVS["discrete-pixels"], *ONP_SGD, "algo.anneal_lr=False")
    jfn, jcfg, jfabric, obs_space, act_space = capture_jax_train_phase(jax_main, overrides, tmp_path, monkeypatch)
    dims, cont = spaces_to_dims(act_space)
    cnn, mlp = tuple(jcfg.algo.cnn_keys.encoder), tuple(jcfg.algo.mlp_keys.encoder)
    params = draw_params(jax_ppo.build_agent(jfabric, dims, cont, jcfg, obs_space)[1], seed=1)
    optimizer = jax_opt(jcfg.algo.optimizer, jcfg.algo.max_grad_norm)
    trainer, _ = port_trainer(overrides, params, A2CTrainer, dims, cont, obs_space, t.T, t.B)
    rollout, last_obs, _ = rollout_from_seed(11, obs_space, cnn + mlp, cnn, dims, cont, t.T, t.B)
    new_params, _, want = jfn(params, optimizer.init(params), rollout, last_obs)
    got = trainer.train_phase({k: _t(v) for k, v in rollout.items()}, {k: _t(v) for k, v in last_obs.items()},
                              None, 0.0, 0.01)
    _hold_family(policy_state_from_jax(jax.device_get(params)), policy_state_from_jax(jax.device_get(new_params)),
                 trainer.agent.state_dict(), got, want)


def test_recurrent_ppo_update_in_bf16_against_jax(tmp_path, monkeypatch):
    """The MLPs in bf16 around an fp32 LSTM, as flax's dtype-less cell computes."""
    import tests.test_torch_ppo_recurrent as t
    from sheeprl_tpu.utils.optim import build_optimizer as jax_opt
    from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import RecurrentPPOTrainer
    from sheeprl_tpu_torch.convert import policy_state_from_jax
    from sheeprl_tpu_torch.utils.optim import build_optimizer

    overrides = (*t.BASE, *t.CASES["continuous-pre-post-mlp"], *ONP_SGD)
    jfn, jcfg, _, params, port, cfg, dims, cont = t._agents(overrides, tmp_path, monkeypatch)
    assert port.encoder.compute_dtype == BF16 and port.lstm.weight_ih.dtype == torch.float32
    rollout, carry, rng = t._sequence(2, dims, cont)
    last_values = rng.standard_normal(t.B).astype(np.float32)
    key = jax.random.PRNGKey(4)
    optimizer = jax_opt(jcfg.algo.optimizer, jcfg.algo.max_grad_norm)
    start = {k: v.clone() for k, v in port.state_dict().items()}
    new_params, _, want = jfn(params, optimizer.init(params), rollout, carry, last_values, key,
                              jnp.float32(jcfg.algo.ent_coef), env_bs=2, num_minibatches=2)
    perms = []
    for k in jax.random.split(key, int(jcfg.algo.update_epochs)):
        perm = np.asarray(jax.random.permutation(k, t.B))
        perms.append(torch.from_numpy(np.concatenate([perm, perm[:4 - t.B]])))
    trainer = RecurrentPPOTrainer(cfg, port, build_optimizer(port.parameters(), cfg.algo.optimizer,
                                                             cfg.algo.max_grad_norm), dims, cont, t.T, t.B)
    got = trainer.train_phase({k: _t(v) for k, v in rollout.items()}, tuple(_t(c) for c in carry),
                              _t(last_values), perms, float(cfg.algo.ent_coef))
    _hold_family(start, policy_state_from_jax(jax.device_get(new_params)), port.state_dict(), got, want)


@pytest.mark.parametrize("algo", ["sac", "droq"])
def test_sac_and_droq_train_phase_in_bf16_against_jax(algo):
    import tests.test_torch_droq as d
    import tests.test_torch_sac as s
    from sheeprl_tpu_torch.convert import sac_state_from_jax

    if algo == "sac":
        overrides, args, kw = [*s.SAC, *OFP_SGD], (s.plain_apply,), {}
    else:
        overrides = [*d.DROQ, "algo.critic.dropout=0.01", *OFP_SGD]
        args, kw = (d.dropout_apply, d.masks_of), dict(B=16, jax_build=d.jax_build_agent, pt_build=d.pt_build_agent)
    start = s.setup(overrides, kw.get("jax_build", s.jax_agent.build_agent),
                    kw.get("pt_build", s.pt_agent.build_agent))[4]
    agent, got, new_params, want = s.run_both(overrides, *args, **kw)
    assert agent.actor.trunk.compute_dtype == BF16
    _hold_family(sac_state_from_jax(start), sac_state_from_jax(new_params), agent.state_dict(), got, want)


def test_sac_ae_train_phase_in_bf16_against_jax(tmp_path, monkeypatch):
    import tests.test_torch_sac_ae as t
    from sheeprl_tpu.algos.sac_ae.agent import build_agent as jax_build
    from sheeprl_tpu.algos.sac_ae.sac_ae import main as jax_main
    from sheeprl_tpu.utils.optim import build_optimizer as jax_opt
    from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent
    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import SACAETrainer
    from sheeprl_tpu_torch.convert import sac_state_from_jax
    from tests.test_torch_ppo import capture_jax_train_phase

    sgd = tuple(f"algo.{g}.optimizer.{k}={v}" for g in ("encoder", "decoder")
                for k, v in (("name", "sgd"), ("lr", 0.05), ("momentum", 0.0)))
    overrides = [*t.SAC_AE, *OFP_SGD, *sgd]
    phase, jcfg, jfabric, obs_space, act_space = capture_jax_train_phase(jax_main, overrides, tmp_path, monkeypatch)
    act_dim = int(np.prod(act_space.shape))
    params = jax.device_get(jax_build(jfabric, act_dim, jcfg, obs_space)[4])
    opts = {g: jax_opt(jcfg.algo[g].optimizer) for g in t.GROUPS}
    o_state = {g: opts[g].init(params["log_alpha" if g == "alpha" else g]) for g in t.GROUPS}
    cfg = compose(overrides)
    agent = build_agent(build_fabric(cfg), act_dim, cfg, obs_space, sac_state_from_jax(params))
    assert agent.decoder.decnn.deconv_0.compute_dtype == BF16
    U, Bs = 4, 4
    host = t.draw_batches(U, Bs, act_dim)
    k = jax.random.PRNGKey(5)
    trainer = SACAETrainer(cfg, agent, SACAETrainer.build_optimizers(cfg, agent), act_dim)
    got = trainer.train_phase({n: _t(v) for n, v in host.items()}, t.jax_noise(k, U, Bs, act_dim), 0)
    new_params, _, want = phase(params, o_state, {n: jnp.asarray(v) for n, v in host.items()}, k, jnp.int32(0))
    _hold_family(sac_state_from_jax(params), sac_state_from_jax(jax.device_get(new_params)), agent.state_dict(), got,
                 want)


@pytest.mark.parametrize("algo", ["ppo", "sac"])
def test_ppo_and_sac_players_in_bf16_against_jax(algo):
    """The ``ppo`` and ``sac`` serving players under bf16-mixed on one fp32
    tree, continuous actions from the JAX step's own draws, greedy and
    sampled rows mixed: the module tier against JAX's bf16 and fp32 players."""
    from sheeprl_tpu.algos.ppo.utils import spaces_to_dims
    from sheeprl_tpu.algos.sac.agent import build_agent as jax_sac_agent
    from sheeprl_tpu.serve.players import PLAYER_BUILDERS as JAX_PLAYERS
    from sheeprl_tpu_torch.convert import policy_state_from_jax, sac_state_from_jax
    from sheeprl_tpu_torch.serve.players import PLAYER_BUILDERS
    from tests.test_torch_ppo import draw_params, jax_action_noise

    base = ["env=dummy", "env.sync_env=True", "env.id=continuous_dummy", "fabric.accelerator=cpu", "algo.mlp_keys.encoder=[state]"]
    base += (["exp=ppo", "algo.cnn_keys.encoder=[]", "algo.dense_units=8", "algo.mlp_layers=1",
              "algo.encoder.mlp_features_dim=6"] if algo == "ppo" else ["exp=sac", "algo.hidden_size=16"])
    cfgs = {p: jax_compose([*base, f"fabric.precision={p}"]) for p in ("bf16-mixed", "32-true")}
    fabrics = {p: jax_build_fabric(c) for p, c in cfgs.items()}
    obs_space, act_space = jax_probe_spaces(cfgs["32-true"])
    if algo == "ppo":
        from sheeprl_tpu.algos.ppo import agent as jax_ppo

        dims, cont = spaces_to_dims(act_space)
        params = draw_params(jax_ppo.build_agent(fabrics["32-true"], dims, cont, cfgs["32-true"], obs_space)[1])
        state = policy_state_from_jax(jax.device_get(params))
    else:
        params = jax.device_get(jax_sac_agent(fabrics["32-true"], 2, cfgs["32-true"], 4)[2])
        state = sac_state_from_jax(params)
    jp = {p: JAX_PLAYERS[algo](fabrics[p], cfgs[p], {"agent": params}, obs_space, act_space) for p in cfgs}
    pcfg = compose([*base, "fabric.precision=bf16-mixed"])
    p_obs, p_act = probe_spaces(pcfg)
    pp = PLAYER_BUILDERS[algo](build_fabric(pcfg), pcfg, {"agent": state}, p_obs, p_act)
    rng, n, seed = np.random.default_rng(6), 4, 21
    raw = {"state": rng.standard_normal((n, 4)).astype(np.float32)}
    greedy = np.array([True, False, False, True])
    want = {p: np.asarray(j.step_batch(j.params, (), j.prepare(raw), seed, greedy)[1]) for p, j in jp.items()}
    if algo == "ppo":
        noise = [_t(x) for x in jax_action_noise(jax.random.PRNGKey(seed), n, dims, cont, "auto")]
    else:
        noise = _t(jax.random.normal(jax.random.PRNGKey(seed), (n, 2)))
    with torch.no_grad():
        _, got = pp.step(pp.params, (), {k: _t(v) for k, v in pp.prepare(raw).items()}, seed,
                         torch.from_numpy(greedy), noise=noise)
    _hold(got, jnp.asarray(want["bf16-mixed"]), want["32-true"])
