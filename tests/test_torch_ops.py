"""The port's fused ops (CPU path = plain version) against the JAX Pallas ops
run in interpret mode, on the same numpy inputs.

Tolerance: fp32 rtol = atol = 2e-5, the JAX kernel tests' own.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

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
    [(1, 5120, 12288), (1, 1030, 1024), (7, 1030, 1024), (12, 5120, 12288), (16, 5120, 12288), (32, 5120, 12288),
     (128, 5120, 12288), (1024, 5120, 12288), (1024, 1028, 1024), (3, 20, 16)],
)
def test_gemm_plan_tiles_k_exactly(B, K, N):
    """The launch plan the C side accepts: the smallest row tile that holds
    the batch, whole K tiles per split, every row of K in exactly one split;
    and a grid that keeps at least 90% of the SMs busy whenever K has tiles
    enough."""
    sms, occupancy = 132, {8: 3, 16: 2, 32: 2, 64: 2, 128: 1}
    bb, splits, kps = _common.plan(B, K, N, sms, occupancy.__getitem__)
    assert bb == next((t for t in _common.ROW_TILES if B <= t), 128)
    assert kps % _common.tile_k(bb) == 0
    assert (splits - 1) * kps < K <= splits * kps
    k_tiles = -(-K // _common.tile_k(bb))
    blocks = -(-N // _common.TILE_N) * -(-B // bb) * splits
    assert blocks >= 0.9 * sms or splits == k_tiles
    assert _common.plan(B, K, N, sms, occupancy.__getitem__) == (bb, splits, kps)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 as ``cvt.rna.tf32.f32`` does: to nearest, ties
    away from zero, the low 13 mantissa bits cleared."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernels' product: both operands split into a TF32 big part and
    the rest, which the tensor core truncates to TF32 (it reads the top 19
    bits); small*big + big*small + big*big summed in fp32."""
    a_big, w_big = _tf32(a), _tf32(w)
    a_small, w_small = ((t.view(torch.int32) & ~0x1FFF).view(torch.float32) for t in (a - a_big, w - w_big))
    return (a_small @ w_big + a_big @ w_small) + a_big @ w_big


@pytest.mark.parametrize("B", [8, 32])
def test_3xtf32_products_hold_fp32_accuracy_at_l_width(B):
    """The precision design of the CUDA kernels, checked before any card
    time: the RSSM step and the LN-GRU cell at DreamerV3-L width
    (D = 768, H = 2048, K = 2816) with every product in emulated 3xTF32
    stay within the kernels' 1e-4 limit on h' of the JAX fp32 reference,
    where one TF32 pass would not."""
    x, h, w = _rssm_inputs((B,), ZA=1028, D=768, H=2048, seed=B)
    w_in, b_in, s_in, o_in, w_gru, s_gru, o_gru = (torch.from_numpy(t) for t in w)
    xt, ht = torch.from_numpy(x), torch.from_numpy(h)
    y = F.silu(_common.layer_norm(_mm_3xtf32(xt, w_in) + b_in, s_in, o_in, 1e-3))

    def gru(inp):
        parts = _mm_3xtf32(torch.cat([inp, ht], -1), w_gru)
        return _common.gru_gates(_common.layer_norm(parts, s_gru, o_gru, 1e-5), ht)

    ref_rssm = np.asarray(rssm_pallas._reference_math(x, h, *w))
    ref_gru = np.asarray(gru_pallas._reference_math(x[:, :768], h, *w[4:]))
    assert np.abs(gru(y).numpy() - ref_rssm).max() <= 1e-4
    assert np.abs(gru(xt[:, :768]).numpy() - ref_gru).max() <= 1e-4
    parts = _tf32(torch.cat([xt[:, :768], ht], -1)) @ _tf32(w_gru)
    one_pass = _common.gru_gates(_common.layer_norm(parts, s_gru, o_gru, 1e-5), ht)
    assert np.abs(one_pass.numpy() - ref_gru).max() > 1e-4


def test_wrappers_refuse_what_the_kernel_does_not_take():
    t = torch.zeros(4, 4)
    with pytest.raises(TypeError, match="float32"):
        _common.check_operands("rssm", t.device, w=t.double())
    with pytest.raises(ValueError, match="contiguous"):
        _common.check_operands("rssm", t.device, w=t.t()[:, :2])
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_layernorm_gru(*(torch.zeros(2, 4, device="meta") for _ in range(2)),
                            torch.zeros(8, 12), torch.ones(12), torch.zeros(12))
