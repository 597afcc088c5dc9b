"""The port's training numerics against the live JAX functions, on numpy
inputs from a seed, and against ``tests/test_regression/reference_fixture.json``
(values computed by the original torch sheeprl) where it has the math.

Tolerances follow ``tests/test_regression/DRIFT.md``: elementwise maths
1e-6 relative; reductions and losses 2e-5 relative / 1e-6 absolute (the
reference-fixture tier); two-hot weights near a bucket edge 1e-4 (as the
fixture test of the JAX package).
"""

import json
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3 import loss as jax_loss
from sheeprl_tpu.algos.dreamer_v3 import utils as jax_dv3_utils
from sheeprl_tpu.utils import distribution as jd
from sheeprl_tpu.utils import optim as jax_optim
from sheeprl_tpu.utils import utils as jax_utils
from sheeprl_tpu_torch.algos.dreamer_v3.loss import world_model_loss
from sheeprl_tpu_torch.algos.dreamer_v3.utils import compute_lambda_values, moments_update
from sheeprl_tpu_torch.utils import distribution as pd
from sheeprl_tpu_torch.utils.optim import build_optimizer
from sheeprl_tpu_torch.utils.utils import (
    Ratio,
    normalize_tensor,
    symexp,
    symlog,
    two_hot_decoder,
    two_hot_encoder,
)
from sheeprl_tpu_torch.utils.structured import dotdict

RTOL, ATOL = 2e-5, 1e-6
FIXTURE = json.loads((Path(__file__).parent / "test_regression" / "reference_fixture.json").read_text())


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def close(p, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(p.detach() if hasattr(p, "detach") else p), np.asarray(j), rtol=rtol, atol=atol)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("name", ["symlog", "symexp", "normalize_tensor"])
def test_elementwise(rng, name):
    x = (rng.standard_normal((6, 7)) * 5).astype(np.float32)
    port = {"symlog": symlog, "symexp": symexp, "normalize_tensor": normalize_tensor}[name]
    ref = getattr(jax_utils, name)
    close(port(t(x)), ref(jnp.asarray(x)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("support,buckets", [(300, None), (5, 11), (20, 255)])
def test_two_hot_encoder_decoder(rng, support, buckets):
    # values on bucket centres, between them, and beyond the support
    x = np.concatenate([rng.standard_normal(20) * 50, [0.0, 1.0, -1.0, 1e9, -1e9]]).astype(np.float32)[:, None]
    close(two_hot_encoder(t(x), support, buckets), jax_utils.two_hot_encoder(jnp.asarray(x), support, buckets),
          rtol=1e-4, atol=1e-4)
    n = buckets or 2 * support + 1
    probs = rng.dirichlet(np.ones(n), size=5).astype(np.float32)
    close(two_hot_decoder(t(probs), support), jax_utils.two_hot_decoder(jnp.asarray(probs), support))


def test_two_hot_matches_reference_fixture():
    sec = FIXTURE["math"]
    inp = sec["inputs"]
    support, buckets = sec["two_hot_support"], sec["two_hot_buckets"]
    close(two_hot_encoder(symexp(t(inp["two_hot_x"])), support, buckets), sec["expected"]["two_hot_encoded"],
          rtol=1e-4, atol=1e-4)
    close(two_hot_decoder(t(inp["two_hot_probs"]), support), symexp(t(sec["expected"]["two_hot_decoded"])))


def _dists(rng):
    """(port, jax, sample value) triples for every distribution of the path."""
    logits = rng.standard_normal((4, 3, 6)).astype(np.float32)
    loc = rng.standard_normal((4, 2)).astype(np.float32)
    scale = rng.uniform(0.1, 1.0, (4, 2)).astype(np.float32)
    mode = rng.standard_normal((4, 5)).astype(np.float32)
    value = rng.standard_normal((4, 5)).astype(np.float32)
    bins = rng.standard_normal((4, 255)).astype(np.float32)
    onehot = np.eye(6, dtype=np.float32)[rng.integers(0, 6, (4, 3))]
    return {
        "onehot_unimix": (pd.OneHotCategorical(t(logits), unimix=0.01), jd.OneHotCategorical(jnp.asarray(logits), 0.01), onehot),
        "normal": (pd.Normal(t(loc), t(scale), 1), jd.Normal(jnp.asarray(loc), jnp.asarray(scale), 1), loc + 0.3),
        "truncated_normal": (pd.TruncatedNormal(t(loc), t(scale)), jd.TruncatedNormal(jnp.asarray(loc), jnp.asarray(scale)),
                             np.clip(loc + 0.2, -0.99, 0.99)),
        "mse": (pd.MSEDistribution(t(mode), 1), jd.MSEDistribution(jnp.asarray(mode), 1), value),
        "symlog": (pd.SymlogDistribution(t(mode), 1), jd.SymlogDistribution(jnp.asarray(mode), 1), value * 10),
        "two_hot": (pd.TwoHotEncodingDistribution(t(bins), dims=1), jd.TwoHotEncodingDistribution(jnp.asarray(bins), dims=1),
                    np.concatenate([[[0.0], [1e12]], value[:2, :1] * 100], 0)),
        "bernoulli": (pd.Bernoulli(t(mode)), jd.Bernoulli(jnp.asarray(mode)), (value > 0).astype(np.float32)),
    }


@pytest.mark.parametrize("name", ["onehot_unimix", "normal", "truncated_normal", "mse", "symlog", "two_hot", "bernoulli"])
def test_distribution(rng, name):
    port, ref, value = _dists(rng)[name]
    close(port.log_prob(t(value)), ref.log_prob(jnp.asarray(value)))
    if hasattr(ref, "entropy"):
        close(port.entropy(), ref.entropy())
    close(port.mode(), ref.mode())
    if hasattr(type(ref), "mean"):
        close(port.mean, ref.mean)


def test_samples_from_the_jax_noise(rng):
    """Each distribution's ``sample_from_noise`` on the noise JAX draws gives JAX's sample."""
    import jax

    key = jax.random.PRNGKey(3)
    logits = rng.standard_normal((5, 7)).astype(np.float32)
    noise = jd.OneHotCategorical.sample_noise(key, logits.shape)
    close(pd.OneHotCategorical(t(logits), 0.01).sample_from_noise(t(noise)),
          jd.OneHotCategorical(jnp.asarray(logits), 0.01).sample(key), 0, 0)
    loc, scale = rng.standard_normal((5, 2)).astype(np.float32), np.full((5, 2), 0.5, np.float32)
    close(pd.Normal(t(loc), t(scale)).sample_from_noise(t(jax.random.normal(key, loc.shape))),
          jd.Normal(jnp.asarray(loc), jnp.asarray(scale)).sample(key), 1e-6, 1e-6)
    u = jax.random.uniform(key, loc.shape, jnp.float32, 1e-6, 1.0 - 1e-6)
    close(pd.TruncatedNormal(t(loc), t(scale)).sample_from_noise(t(u)),
          jd.TruncatedNormal(jnp.asarray(loc), jnp.asarray(scale)).sample(key), 1e-5, 1e-5)
    close(pd.Bernoulli(t(loc)).sample_from_noise(t(jax.random.uniform(key, loc.shape))),
          jd.Bernoulli(jnp.asarray(loc)).sample(key), 0, 0)


def test_truncated_normal_matches_reference_fixture():
    sec = FIXTURE["truncated_normal"]
    inp = sec["inputs"]
    d = pd.TruncatedNormal(t(inp["loc"]), t(inp["scale"]), -1.0, 1.0)
    close(d.log_prob(t(inp["value"])), sec["expected"]["log_prob"], 1e-4, 1e-5)
    close(d.mean, sec["expected"]["mean"], 1e-4, 1e-5)
    close(d.entropy(), sec["expected"]["entropy"], 1e-4, 1e-5)


def test_kl_categorical(rng):
    p, q = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
    close(pd.kl_categorical(pd.OneHotCategorical(t(p)), pd.OneHotCategorical(t(q), 0.01)),
          jd.kl_categorical(jd.OneHotCategorical(jnp.asarray(p)), jd.OneHotCategorical(jnp.asarray(q), 0.01)))


def _wm_loss_inputs(source):
    inp = {k: np.asarray(v, np.float32) for k, v in source.items()}
    return inp


@pytest.mark.parametrize("source", ["reference_fixture", "random"])
def test_world_model_loss(rng, source):
    meta = FIXTURE["meta"]
    if source == "reference_fixture":
        inp = _wm_loss_inputs(FIXTURE["inputs"])
    else:
        T, Bb, S, D = 3, 2, 4, 8
        inp = {
            "cnn_target": rng.uniform(-0.5, 0.5, (T, Bb, 4, 4, 3)), "cnn_recon": rng.standard_normal((T, Bb, 4, 4, 3)),
            "mlp_target": rng.standard_normal((T, Bb, 5)) * 3, "mlp_recon": rng.standard_normal((T, Bb, 5)),
            "reward_logits": rng.standard_normal((T, Bb, 255)), "rewards": rng.standard_normal((T, Bb)) * 4,
            "continue_logits": rng.standard_normal((T, Bb)), "terminated": (rng.random((T, Bb)) < 0.3) * 1.0,
            "posterior_logits": rng.standard_normal((T, Bb, S, D)) * 2, "prior_logits": rng.standard_normal((T, Bb, S, D)),
        }
        inp = {k: np.asarray(v, np.float32) for k, v in inp.items()}

    def losses(m, dist, to):
        lp = {
            "rgb": dist.MSEDistribution(to(inp["cnn_recon"]), event_dims=3).log_prob(to(inp["cnn_target"])),
            "state": dist.SymlogDistribution(to(inp["mlp_recon"]), event_dims=1).log_prob(to(inp["mlp_target"])),
        }
        reward = dist.TwoHotEncodingDistribution(to(inp["reward_logits"]), dims=1).log_prob(to(inp["rewards"])[..., None])
        cont = dist.Bernoulli(to(inp["continue_logits"]), event_dims=0).log_prob(1.0 - to(inp["terminated"]))
        return m.world_model_loss(lp, reward, cont, to(inp["posterior_logits"]), to(inp["prior_logits"]),
                                  continue_scale_factor=meta["continue_scale_factor"], **meta["kl_kwargs"])

    class _Port:
        world_model_loss = staticmethod(world_model_loss)

    p_total, p_aux = losses(_Port, pd, t)
    j_total, j_aux = losses(jax_loss, jd, jnp.asarray)
    close(p_total, j_total)
    for k in j_aux:
        close(p_aux[k], j_aux[k])
    if source == "reference_fixture":
        exp = FIXTURE["expected"]
        close(p_total, exp["world_model_loss"])
        close(p_aux["kl"], exp["kl"])
        close(p_aux["kl_loss"], exp["state_loss"])
        for k in ("reward_loss", "observation_loss", "continue_loss"):
            close(p_aux[k], exp[k])


def test_moments_update(rng):
    x = (rng.standard_normal((15, 64)) * 3).astype(np.float32)
    moments = {"low": np.float32(-0.3), "high": np.float32(0.8)}
    kw = dict(decay=0.99, max_=1.0, plow=0.05, phigh=0.95)
    p_new, p_off, p_inv = moments_update({k: torch.tensor(v) for k, v in moments.items()}, t(x), **kw)
    j_new, j_off, j_inv = jax_dv3_utils.moments_update({k: jnp.asarray(v) for k, v in moments.items()}, jnp.asarray(x), **kw)
    for a, b in ((p_new["low"], j_new["low"]), (p_new["high"], j_new["high"]), (p_off, j_off), (p_inv, j_inv)):
        close(a, b, 1e-6, 1e-6)


@pytest.mark.parametrize("source", ["reference_fixture", "random"])
def test_compute_lambda_values(rng, source):
    if source == "reference_fixture":
        inp = FIXTURE["math"]["inputs"]
        r, v, c = (np.asarray(inp[k], np.float32) for k in ("lam_rewards", "lam_values", "lam_continues"))
        lmbda = FIXTURE["math"]["lmbda"]
        close(compute_lambda_values(t(r), t(v), t(c), lmbda), FIXTURE["math"]["expected"]["lambda_values"])
    else:
        r, v = rng.standard_normal((2, 15, 32)).astype(np.float32)
        c = (rng.random((15, 32)) > 0.1).astype(np.float32) * 0.997
        lmbda = 0.95
    close(compute_lambda_values(t(r), t(v), t(c), lmbda),
          jax_dv3_utils.compute_lambda_values(jnp.asarray(r), jnp.asarray(v), jnp.asarray(c), lmbda))


@pytest.mark.parametrize("case", range(len(FIXTURE["math"]["ratio_cases"])))
def test_ratio_and_state_dict(case):
    spec = FIXTURE["math"]["ratio_cases"][case]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        port, ref = Ratio(spec["ratio"], spec["pretrain_steps"]), jax_utils.Ratio(spec["ratio"], spec["pretrain_steps"])
        got = [port(c) for c in spec["calls"]]
        assert got == spec["expected"] == [ref(c) for c in spec["calls"]]
        r1 = Ratio(spec["ratio"], pretrain_steps=spec["pretrain_steps"])
        r1(spec["calls"][0])
        state = r1.state_dict()
        assert state == jax_utils.Ratio(spec["ratio"]).load_state_dict(state).state_dict()
        r2 = Ratio(spec["ratio"]).load_state_dict(state)
        assert [r1(c) for c in spec["calls"][1:]] == [r2(c) for c in spec["calls"][1:]]


@pytest.mark.parametrize("name", ["adam", "sgd"])
@pytest.mark.parametrize("clip", [None, 0.5])
def test_optimizer_step_matches_optax(rng, name, clip):
    """One step of each optimizer, with and without optax's global-norm clip
    (the gradients' norm is about 3, so the 0.5 clip is active)."""
    cfg = dotdict({"name": name, "lr": 0.01, "eps": 1e-5, "betas": [0.9, 0.999], "momentum": 0.0})
    params = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (3,))]
    grads = [rng.standard_normal(p.shape).astype(np.float32) for p in params]
    torch_params = [torch.nn.Parameter(t(p)) for p in params]
    opt = build_optimizer(torch_params, cfg, clip)
    for p, g in zip(torch_params, grads):
        p.grad = t(g)
    norm = opt.step()
    tx = jax_optim.build_optimizer(cfg, clip)
    jp = [jnp.asarray(p) for p in params]
    updates, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(jp), jp)
    for p_t, p_j in zip(torch_params, optax.apply_updates(jp, updates)):
        close(p_t, p_j, 1e-6, 1e-7)
    if clip:
        close(norm, optax.global_norm([jnp.asarray(g) for g in grads]), 1e-6, 1e-6)
