"""The port's fused ops (CPU path = plain version) against the JAX Pallas ops
run in interpret mode, on the same numpy inputs.

Tolerance: fp32 rtol = atol = 2e-5, the JAX kernel tests' own.
"""

import numpy as np
import pytest
import torch

from sheeprl_tpu.ops import gru_pallas, rssm_pallas
from sheeprl_tpu_torch.ops import _common, fused_layernorm_gru, fused_rssm_recurrent
from sheeprl_tpu_torch.ops.gru import layernorm_gru_reference
from sheeprl_tpu_torch.ops.rssm import rssm_recurrent_reference

TOL = dict(rtol=2e-5, atol=2e-5)


def _rssm_inputs(lead, ZA, D, H, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    x = f(*lead, ZA)
    h = np.tanh(f(*lead, H))
    weights = (
        f(ZA, D, scale=ZA**-0.5), f(D, scale=0.1), 1 + f(D, scale=0.1), f(D, scale=0.1),
        f(D + H, 3 * H, scale=(D + H) ** -0.5), 1 + f(3 * H, scale=0.1), f(3 * H, scale=0.1),
    )
    return x, h, weights


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("lead", [(6,), (5,), (2, 3)], ids=["B6", "odd-B5", "lead-2x3"])
def test_rssm_matches_jax_resident_kernel(lead):
    """S-size weights go through the VMEM-resident Pallas kernel."""
    x, h, w = _rssm_inputs(lead, ZA=20, D=16, H=24)
    ref = rssm_pallas.fused_rssm_recurrent(x, h, *w, block_b=4, interpret=True)
    out = fused_rssm_recurrent(*_torch(x, h, *w))
    assert out.shape == (*lead, 24)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_rssm_matches_jax_tiled_kernel():
    """The column-tiled Pallas kernel (M/L/XL) at small dims: 3H = 1536 is
    three 512-wide column tiles, B = 11 pads over batch tiles of 4."""
    x, h, w = _rssm_inputs((11,), ZA=20, D=256, H=512)
    ref = rssm_pallas._pallas_forward_tiled(x, h, *w, block_b=4, interpret=True)
    out = fused_rssm_recurrent(*_torch(x, h, *w))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("lead", [(6,), (7,), (2, 3)], ids=["B6", "odd-B7", "lead-2x3"])
def test_gru_matches_jax_kernel(lead):
    rng = np.random.default_rng(1)
    D, H = 12, 16
    x = rng.standard_normal((*lead, D)).astype(np.float32)
    h = np.tanh(rng.standard_normal((*lead, H))).astype(np.float32)
    w = (rng.standard_normal((D + H, 3 * H)) * (D + H) ** -0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(3 * H)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(3 * H)).astype(np.float32)
    ref = gru_pallas.fused_layernorm_gru(x, h, w, scale, bias, block_b=4, interpret=True)
    out = fused_layernorm_gru(*_torch(x, h, w, scale, bias))
    assert out.shape == (*lead, H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_plain_versions_match_jax_reference_math():
    x, h, w = _rssm_inputs((4,), ZA=10, D=8, H=8)
    np.testing.assert_allclose(
        rssm_recurrent_reference(*_torch(x, h, *w)).numpy(),
        np.asarray(rssm_pallas._reference_math(x, h, *w)),
        **TOL,
    )
    np.testing.assert_allclose(
        layernorm_gru_reference(*_torch(x[:, :8], h, w[4], w[5], w[6])).numpy(),
        np.asarray(gru_pallas._reference_math(x[:, :8], h, w[4], w[5], w[6])),
        **TOL,
    )


def test_gradients_match_jax_custom_vjp():
    """Both backward passes differentiate the plain math."""
    import jax

    x, h, w = _rssm_inputs((3,), ZA=10, D=8, H=8)
    g_jax = jax.grad(
        lambda *a: (rssm_pallas.fused_rssm_recurrent(*a, interpret=True) ** 2).sum(), argnums=(0, 1, 2, 6)
    )(x, h, *w)
    args = [t.requires_grad_(i in (0, 1, 2, 6)) for i, t in enumerate(_torch(x, h, *w))]
    (fused_rssm_recurrent(*args) ** 2).sum().backward()
    for got, want in zip((args[0], args[1], args[2], args[6]), g_jax):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize(
    "B,K,N",
    [(1, 5120, 12288), (1, 1030, 1024), (7, 1030, 1024), (12, 5120, 12288), (32, 5120, 12288), (128, 5120, 12288),
     (3, 20, 16)],
)
def test_gemm_plan_tiles_k_exactly(B, K, N, monkeypatch):
    """The launch plan the C side accepts: whole K tiles per split, every
    row of K in exactly one split, and no more blocks than the card holds
    at once unless one split per column tile already exceeds that."""
    monkeypatch.setitem(_common._SM_COUNT, 0, 132)

    def blocks_per_sm(bm):
        return {8: 6, 32: 3, 64: 1}[bm]

    bm, splits, kps = _common.plan(blocks_per_sm, B, K, N, torch.device("cuda", 0))
    assert bm >= min(B, 64) and bm in (8, 32, 64)
    assert kps % _common.TILE_K == 0
    assert (splits - 1) * kps < K <= splits * kps
    blocks = -(-N // _common.TILE_N) * -(-B // bm)
    assert splits == 1 or blocks * splits <= 132 * blocks_per_sm(bm)


def test_wrappers_refuse_what_the_kernel_does_not_take():
    t = torch.zeros(4, 4)
    with pytest.raises(TypeError, match="float32"):
        _common.check_operands("rssm", t.device, w=t.double())
    with pytest.raises(ValueError, match="contiguous"):
        _common.check_operands("rssm", t.device, w=t.t()[:, :2])
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_layernorm_gru(*(torch.zeros(2, 4, device="meta") for _ in range(2)),
                            torch.zeros(8, 12), torch.ones(12), torch.zeros(12))
