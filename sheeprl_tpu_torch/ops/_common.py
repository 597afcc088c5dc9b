"""Host side shared by the ``gru`` and ``rssm`` ops: the launch plan of the
split-K 3xTF32 GEMM in ``csrc/rssm_common.cuh``, operand checks, error
reporting and the fp32 math both plain versions use."""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

# must match kBK / kBN and GemmTile in csrc/rssm_common.cuh
TILE_K = 32
TILE_N = 128
ROW_TILES = (8, 16, 32, 64, 128)


def tile_k(bb: int) -> int:
    """K rows per pipeline stage of the GEMM with row tile ``bb``."""
    return 2 * TILE_K if bb >= 128 else TILE_K


# The plan's cost model (only the ratios matter): the data-sheet memory
# rate, shared evenly by the SMs; the rate of the three products of 3xTF32
# that the kernel reached at B = 1024 on an H100 (PERF.md); and the pipeline
# fill and epilogue of each wave of resident blocks.
_HBM_BYTES_PER_S = 3.35e12
_MMA_FLOPS_PER_S = 150e12
_WAVE_S = 1e-6

_SM_COUNT: Dict[int, int] = {}
_BLOCKS_PER_SM: Dict[Tuple[str, int], int] = {}
_PLANS: Dict[Tuple, Tuple[int, int, int]] = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(B: int, K: int, N: int, sms: int, blocks_per_sm: Callable[[int], int]) -> Tuple[int, int, int]:
    """``(row_tile, splits, k_per_split)`` for ``(B, K) @ (K, N)`` on a card
    with ``sms`` SMs, where ``blocks_per_sm(row_tile)`` GEMM blocks fit on
    an SM.

    The row tile is the smallest that holds the batch (8, 16, 32, 64, else
    128 rows per block).  K is cut into ``splits`` slices of whole K tiles,
    as many as minimise the larger of two times on the busiest SM, which is
    handed ``ceil(blocks / sms)`` blocks: streaming their weight tiles (and
    writing their partial sums) at its share of the memory rate, and their
    products.  The row kernels' reading of the partial sums and a pipeline
    fill per wave of resident blocks are added.  Of the splits within 2% of
    the best time the fewest win.  Every row of K is in exactly one split."""
    bb = next((t for t in ROW_TILES if B <= t), ROW_TILES[-1])
    slots = sms * blocks_per_sm(bb)
    tiles = _cdiv(N, TILE_N) * _cdiv(B, bb)
    tk = tile_k(bb)
    k_tiles = _cdiv(K, tk)
    costs: Dict[int, Tuple[float, int]] = {}
    for want in range(1, k_tiles + 1):
        kps = _cdiv(k_tiles, want) * tk
        splits = _cdiv(K, kps)
        if splits in costs:
            continue
        blocks = tiles * splits
        per_sm = _cdiv(blocks, sms)
        t_bytes = per_sm * 4 * (kps * TILE_N + bb * kps + bb * TILE_N) / (_HBM_BYTES_PER_S / sms)
        t_ops = per_sm * 6 * bb * TILE_N * kps / (_MMA_FLOPS_PER_S / sms)
        t_rows = 4 * splits * B * N / _HBM_BYTES_PER_S
        costs[splits] = (max(t_bytes, t_ops) + t_rows + _cdiv(blocks, slots) * _WAVE_S, kps)
    best = min(cost for cost, _ in costs.values())
    splits = min(s for s, (cost, _) in costs.items() if cost <= 1.02 * best)
    return bb, splits, costs[splits][1]


def launch_plan(blocks_per_sm: Callable[[int], int], B: int, K: int, N: int, device: torch.device):
    """:func:`plan` for the card of ``device``: its SM count and the GEMM's
    occupancy are queried once (``blocks_per_sm`` is the library's query),
    and each plan is computed once per shape."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    name = getattr(blocks_per_sm, "__name__", repr(blocks_per_sm))
    key = (name, index, B, K, N)
    if key in _PLANS:
        return _PLANS[key]
    if index not in _SM_COUNT:
        _SM_COUNT[index] = torch.cuda.get_device_properties(index).multi_processor_count

    def occupancy(bb: int) -> int:
        if (name, bb) not in _BLOCKS_PER_SM:
            n = int(blocks_per_sm(bb))
            if n <= 0:
                raise RuntimeError(f"occupancy query for the GEMM (row tile {bb}) failed with code {-n}")
            _BLOCKS_PER_SM[name, bb] = n
        return _BLOCKS_PER_SM[name, bb]

    _PLANS[key] = plan(B, K, N, _SM_COUNT[index], occupancy)
    return _PLANS[key]


def check_operands(op: str, device: torch.device, **tensors: torch.Tensor) -> None:
    """Raise on anything the kernel does not take: another device, a dtype
    other than fp32, a non-contiguous or misaligned buffer."""
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{op}: {name} is on {t.device}, the input is on {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{op}: {name} is {t.dtype}; the kernel takes float32 only")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{op}: {name} must be 16-byte aligned")


def check_status(op: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{op} kernel launch failed: cudaError_t {code}")


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 LayerNorm over the last axis with explicit mean and variance
    (``_ln`` of the JAX ops)."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def gru_gates(parts: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The Hafner gates on the normalised (B, 3H) row: ``h' = u*c + (1-u)*h``."""
    H = h.shape[-1]
    reset = torch.sigmoid(parts[..., :H])
    cand = torch.tanh(reset * parts[..., H : 2 * H])
    update = torch.sigmoid(parts[..., 2 * H :] - 1.0)
    return update * cand + (1.0 - update) * h


def needs_grad(tensors) -> bool:
    """Whether autograd has to record a call on ``tensors``.  The wrappers
    skip their ``autograd.Function`` otherwise: recording costs tens of
    microseconds of host time per call, of the order of the kernel itself at
    small batch."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def reference_backward(fn, ctx, grad):
    """Gradients of ``fn`` at the saved inputs, for the inputs that need them."""
    inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    wanted = [t for t, need in zip(inputs, ctx.needs_input_grad) if need]
    with torch.enable_grad():
        grads = iter(torch.autograd.grad(fn(*inputs), wanted, grad))
    return tuple(next(grads) if need else None for need in ctx.needs_input_grad)
