"""The port's CUDA kernels against their plain versions, on the card.

Hand-written kernels have no CPU mode, so these tests skip without a GPU.
On a CUDA host: ``python -m pytest tests/test_torch_cuda_kernels.py -q``.
Tolerance: max abs error 1e-4 on h' (fp32 sums over K in another order).
"""

import pytest
import torch

from sheeprl_tpu_torch.ops import gru, rssm

pytestmark = pytest.mark.cuda
TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _weights(ZA, D, H, dev, seed=0):
    g = torch.Generator(dev).manual_seed(seed)

    def rnd(*s, scale=1.0):
        return torch.randn(*s, device=dev, generator=g) * scale

    return (rnd(ZA, D, scale=ZA**-0.5), rnd(D, scale=0.1), 1 + rnd(D, scale=0.1), rnd(D, scale=0.1),
            rnd(D + H, 3 * H, scale=(D + H) ** -0.5), 1 + rnd(3 * H, scale=0.1), rnd(3 * H, scale=0.1))


@pytest.mark.parametrize("lead", [(1,), (5,), (8,), (16,), (32,), (33,), (64,), (128,), (1024,), (2, 3)])
@pytest.mark.parametrize("ZA,D,H", [(1030, 64, 96), (20, 16, 24), (1028, 512, 512), (1028, 1024, 4096)])
def test_kernels_match_plain_versions(dev, lead, ZA, D, H):
    w = _weights(ZA, D, H, dev)
    x = torch.randn(*lead, ZA, device=dev)
    y = torch.randn(*lead, D, device=dev)
    h = torch.tanh(torch.randn(*lead, H, device=dev))
    before = (rssm.LAUNCHES["rssm"], gru.LAUNCHES["gru"])
    out_r = rssm.fused_rssm_recurrent(x, h, *w)
    out_g = gru.fused_layernorm_gru(y, h, *w[4:])
    assert (rssm.LAUNCHES["rssm"], gru.LAUNCHES["gru"]) == (before[0] + 1, before[1] + 1)
    assert (out_r - rssm.rssm_recurrent_reference(x, h, *w)).abs().max().item() <= TOL
    assert (out_g - gru.layernorm_gru_reference(y, h, *w[4:])).abs().max().item() <= TOL


@pytest.mark.parametrize("B", [1, 32, 1024])
def test_two_calls_are_bitwise_equal(dev, B):
    """Partial sums are added in a fixed order and no float atomics are
    used, so the same inputs give the same bits."""
    w = _weights(1028, 1024, 4096, dev)
    x, y = torch.randn(B, 1028, device=dev), torch.randn(B, 1024, device=dev)
    h = torch.tanh(torch.randn(B, 4096, device=dev))
    assert torch.equal(rssm.fused_rssm_recurrent(x, h, *w), rssm.fused_rssm_recurrent(x, h, *w))
    assert torch.equal(gru.fused_layernorm_gru(y, h, *w[4:]), gru.fused_layernorm_gru(y, h, *w[4:]))


def test_backward_runs_through_the_plain_version(dev):
    w = [t.requires_grad_() for t in _weights(40, 32, 48, dev)]
    x, h = torch.randn(3, 40, device=dev), torch.randn(3, 48, device=dev)
    (rssm.fused_rssm_recurrent(x, h, *w) ** 2).sum().backward()
    grads = [t.grad.clone() for t in w]
    for t in w:
        t.grad = None
    (rssm.rssm_recurrent_reference(x, h, *w) ** 2).sum().backward()
    for got, t in zip(grads, w):
        torch.testing.assert_close(got, t.grad)


def test_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    w = _weights(20, 16, 24, dev)
    with pytest.raises(TypeError, match="float32"):
        rssm.fused_rssm_recurrent(torch.zeros(2, 20, device=dev), torch.zeros(2, 24, device=dev),
                                  w[0].double(), *w[1:])
    with pytest.raises(ValueError, match="is on"):
        gru.fused_layernorm_gru(torch.zeros(2, 16, device=dev), torch.zeros(2, 24, device=dev),
                                w[4].cpu(), w[5], w[6])
    with pytest.raises(ValueError, match="H % 4"):
        gru.fused_layernorm_gru(torch.zeros(2, 16, device=dev), torch.zeros(2, 6, device=dev),
                                torch.zeros(22, 18, device=dev), torch.ones(18, device=dev),
                                torch.zeros(18, device=dev))


@pytest.mark.parametrize("B", [16, 1024])
@pytest.mark.parametrize("wrt", ["x_h", "all"])
def test_gradients_match_autograd_of_the_plain_versions(dev, B, wrt):
    """The training path's gradients at the posterior-scan (B = 16) and
    imagination (B = 1024) batches, S width: with respect to x and h only
    (the imagination's frozen world model) and to every input (the world
    model's update).  Both differentiate the same plain version at the
    saved inputs; the upstream gradient is random so every output counts."""
    ZA, D, H = 1028, 512, 512
    w = list(_weights(ZA, D, H, dev, seed=B))
    x, y = torch.randn(B, ZA, device=dev), torch.randn(B, D, device=dev)
    h = torch.tanh(torch.randn(B, H, device=dev))
    up = torch.randn(B, H, device=dev)
    cases = (
        (rssm.fused_rssm_recurrent, rssm.rssm_recurrent_reference, [x, h, *w], "rssm"),
        (gru.fused_layernorm_gru, gru.layernorm_gru_reference, [y, h, *w[4:]], "gru"),
    )
    for fused, plain, inputs, name in cases:
        grads = []
        for fn in (fused, plain):
            leaves = [t.detach().clone().requires_grad_(wrt == "all" or i < 2) for i, t in enumerate(inputs)]
            before = (rssm.LAUNCHES["rssm"], gru.LAUNCHES["gru"])
            (fn(*leaves) * up).sum().backward()
            if fn is fused:
                assert (rssm.LAUNCHES["rssm"], gru.LAUNCHES["gru"]) != before, f"{name}: no kernel launch"
            grads.append([t.grad for t in leaves])
        for i, (got, want) in enumerate(zip(*grads)):
            if want is None:
                assert got is None
                continue
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * want.abs().max().item(),
                                       msg=f"{name} input {i}")


@pytest.mark.parametrize("B", [1, 16, 1024])
def test_captured_graph_replays_the_kernels(dev, B):
    """Both kernels inside one captured CUDA graph (``parallel/compile.py``):
    the replay equals the eager call bit for bit, on the capture's inputs and
    on new ones copied into its buffers, and each replay is credited with
    the launches the capture recorded."""
    from sheeprl_tpu_torch.parallel.compile import GraphFunction
    from sheeprl_tpu_torch.telemetry.monitors import CompileMonitor

    w = _weights(1028, 1024, 4096, dev)

    def step(x, y, h):
        return rssm.fused_rssm_recurrent(x, h, *w), gru.fused_layernorm_gru(y, h, *w[4:])

    f = GraphFunction(step, name="kernels", device=dev, monitor=CompileMonitor())
    for _ in range(2):
        x, y = torch.randn(B, 1028, device=dev), torch.randn(B, 1024, device=dev)
        h = torch.tanh(torch.randn(B, 4096, device=dev))
        want = step(x, y, h)
        before = (rssm.LAUNCHES["rssm"], gru.LAUNCHES["gru"])
        got = [t.clone() for t in f(x, y, h)]
        assert (rssm.LAUNCHES["rssm"], gru.LAUNCHES["gru"]) == (before[0] + 1, before[1] + 1)
        assert all(torch.equal(a, b) for a, b in zip(want, got))
    assert f.cache_size() == 1 and f.replays == 1
