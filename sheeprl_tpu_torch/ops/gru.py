"""Fused LayerNorm-GRU cell: a hand-written Hopper kernel and its plain version.

Counterpart of ``sheeprl_tpu/ops/gru_pallas.py``.  :func:`fused_layernorm_gru`
takes any leading dims, like the JAX entry point.  For tensors on the CPU it
computes :func:`layernorm_gru_reference`; for CUDA tensors it launches the
kernel of ``csrc/gru.cu`` (split-K GEMM on ``[x, h]`` + a row epilogue) or
raises.  The Pallas op refused weights over 12 MiB (its VMEM budget); the
CUDA kernel streams the weight and serves every DreamerV3 preset.

The backward pass differentiates the plain version, as the JAX
``custom_vjp`` differentiates ``_reference_math``.
"""

from __future__ import annotations

import ctypes

import torch

from sheeprl_tpu_torch.ops import _build
from sheeprl_tpu_torch.ops._common import (
    check_operands,
    check_status,
    gru_gates,
    layer_norm,
    launch_plan,
    needs_grad,
    reference_backward,
    stream,
)

LN_EPS = 1e-5  # models.LayerNorm default
LAUNCHES = {"gru": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "sheeprl_gru_forward": [_P] * 7 + [_I] * 6 + [_P],
    "sheeprl_gru_blocks_per_sm": [_I],
}


def layernorm_gru_reference(
    x: torch.Tensor, h: torch.Tensor, w: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor
) -> torch.Tensor:
    """The same math in fp32 torch ops (``_reference_math`` of the JAX op)."""
    f32 = torch.float32
    h = h.to(f32)
    parts = torch.cat([x.to(f32), h], dim=-1) @ w.to(f32)
    parts = layer_norm(parts, ln_scale.to(f32), ln_bias.to(f32), LN_EPS)
    return gru_gates(parts, h)


def _launch(x, h, w, ln_scale, ln_bias) -> torch.Tensor:
    B, D = x.shape
    H = h.shape[-1]
    if h.shape != (B, H) or w.shape != (D + H, 3 * H) or ln_scale.shape != (3 * H,) or ln_bias.shape != (3 * H,):
        raise ValueError(
            f"fused_layernorm_gru: shapes x {tuple(x.shape)}, h {tuple(h.shape)}, w {tuple(w.shape)}, "
            f"ln {tuple(ln_scale.shape)}/{tuple(ln_bias.shape)} do not form one (D, H) cell"
        )
    if H % 4:
        raise ValueError(f"fused_layernorm_gru: the kernel needs H % 4 == 0, got H={H}")
    device = x.device
    check_operands("gru", device, x=x, h=h, w=w, ln_scale=ln_scale, ln_bias=ln_bias)
    out = torch.empty((B, H), device=device, dtype=torch.float32)
    if B == 0:
        return out
    lib = _build.load("gru", _SIGNATURES)
    with torch.cuda.device(device):
        bb, splits, kps = launch_plan(lib.sheeprl_gru_blocks_per_sm, B, D + H, 3 * H, device)
        parts = torch.empty((splits, B, 3 * H), device=device, dtype=torch.float32)
        code = lib.sheeprl_gru_forward(
            *(t.data_ptr() for t in (x, h, w, ln_scale, ln_bias, out, parts)),
            B, D, H, bb, splits, kps, stream(device),
        )
    check_status("gru", code)
    LAUNCHES["gru"] += 1
    return out


class _FusedGRU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h, w, ln_scale, ln_bias):
        ctx.save_for_backward(x, h, w, ln_scale, ln_bias)
        return _launch(x, h, w, ln_scale, ln_bias)

    @staticmethod
    def backward(ctx, grad):
        return reference_backward(layernorm_gru_reference, ctx, grad)


def fused_layernorm_gru(
    x: torch.Tensor, h: torch.Tensor, w: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor
) -> torch.Tensor:
    """One LayerNorm-GRU step.

    Args:
        x: (..., D) inputs.  h: (..., H) previous state; either may be in a
        lower compute dtype (cast to fp32 here).  w: (D+H, 3H) fused
        kernel, (in, out) layout.  ln_scale/ln_bias: (3H,) LayerNorm params.
    Returns:
        (..., H) new state, fp32.
    """
    lead = x.shape[:-1]
    # the kernel is fp32: inputs in the compute dtype are cast here, as the
    # JAX op casts them (the backward returns their gradients through the cast)
    x2 = x.reshape(-1, x.shape[-1]).float()
    h2 = h.reshape(-1, h.shape[-1]).float()
    if x.device.type == "cpu":
        out = layernorm_gru_reference(x2, h2, w, ln_scale, ln_bias)
    elif x.device.type == "cuda":
        args = (x2, h2, w, ln_scale, ln_bias)
        out = _FusedGRU.apply(*args) if needs_grad(args) else _launch(*args)
    else:
        raise ValueError(f"fused_layernorm_gru: no kernel for device {x.device}")
    return out.reshape(*lead, out.shape[-1])
