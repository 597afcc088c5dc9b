"""Host side shared by the ``gru`` and ``rssm`` ops: the launch plan of the
split-K GEMM in ``csrc/rssm_common.cuh``, operand checks, error reporting and
the fp32 math both plain versions use."""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Tuple

import torch

# must match kBK / kBN in csrc/rssm_common.cuh
TILE_K = 32
TILE_N = 128

_SM_COUNT: Dict[int, int] = {}
_BLOCKS_PER_SM: Dict[Tuple[str, int], int] = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(
    blocks_per_sm: Callable[[int], int], B: int, K: int, N: int, device: torch.device
) -> Tuple[int, int, int]:
    """``(bm, splits, k_per_split)`` for ``(B, K) @ (K, N)``.

    ``bm`` is the smallest row tile that holds the batch (8, 32, else 64).
    Serving batches are small, so the column tiles alone may not fill the
    card: K is then cut into ``splits`` slices until the grid reaches
    the blocks the card can keep resident at once (SMs x occupancy), so that
    every SM streams its share of the weight.  Each slice is a whole number
    of K tiles, and the row kernels sum exactly ``splits`` partial slices."""
    bm = next((b for b in (8, 32) if B <= b), 64)
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SM_COUNT:
        _SM_COUNT[index] = torch.cuda.get_device_properties(index).multi_processor_count
    key = (getattr(blocks_per_sm, "__name__", repr(blocks_per_sm)), bm)
    if key not in _BLOCKS_PER_SM:
        occupancy = int(blocks_per_sm(bm))
        if occupancy <= 0:
            raise RuntimeError(f"occupancy query for the GEMM (bm={bm}) failed with code {-occupancy}")
        _BLOCKS_PER_SM[key] = occupancy
    blocks = _cdiv(N, TILE_N) * _cdiv(B, bm)
    tiles = _cdiv(K, TILE_K)
    splits = max(1, min(tiles, _SM_COUNT[index] * _BLOCKS_PER_SM[key] // blocks))
    k_per_split = _cdiv(tiles, splits) * TILE_K
    return bm, _cdiv(K, k_per_split), k_per_split


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


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


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


def reference_backward(fn, ctx, grad):
    """Gradients of ``fn`` at the saved inputs, for the inputs that need them."""
    inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    wanted = [t for t, need in zip(inputs, ctx.needs_input_grad) if need]
    with torch.enable_grad():
        grads = iter(torch.autograd.grad(fn(*inputs), wanted, grad))
    return tuple(next(grads) if need else None for need in ctx.needs_input_grad)
