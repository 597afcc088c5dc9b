"""Fused RSSM recurrent step: a hand-written Hopper kernel and its plain version.

Counterpart of ``sheeprl_tpu/ops/rssm_pallas.py``, whose two Pallas kernels
(VMEM-resident for S, column-tiled for M/L/XL) become one CUDA kernel path
in ``csrc/rssm.cu`` that serves every preset.  :func:`fused_rssm_recurrent`
takes any leading dims.  For tensors on the CPU it computes
:func:`rssm_recurrent_reference`; for CUDA tensors it launches the kernel or
raises.  The backward pass differentiates the plain version, as the JAX
``custom_vjp`` does.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

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

LN_IN_EPS = 1e-3   # RecurrentModel input LayerNorm
LN_GRU_EPS = 1e-5  # models.LayerNorm default (GRU projection LN)
LAUNCHES = {"rssm": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "sheeprl_rssm_forward": [_P] * 13 + [_I] * 9 + [_P],
    "sheeprl_rssm_blocks_per_sm": [_I],
}


def rssm_recurrent_reference(x, h, w_in, b_in, ln_in_scale, ln_in_bias, w_gru, gru_scale, gru_bias):
    """The same math in fp32 torch ops (``_reference_math`` of the JAX op)."""
    f32 = torch.float32
    y = x.to(f32) @ w_in.to(f32) + b_in.to(f32)
    y = F.silu(layer_norm(y, ln_in_scale.to(f32), ln_in_bias.to(f32), LN_IN_EPS))
    h = h.to(f32)
    parts = torch.cat([y, h], dim=-1) @ w_gru.to(f32)
    parts = layer_norm(parts, gru_scale.to(f32), gru_bias.to(f32), LN_GRU_EPS)
    return gru_gates(parts, h)


def _launch(x, h, w_in, b_in, ln_in_scale, ln_in_bias, w_gru, gru_scale, gru_bias) -> torch.Tensor:
    B, ZA = x.shape
    H = h.shape[-1]
    D = w_in.shape[-1]
    shapes_ok = (
        h.shape == (B, H)
        and w_in.shape == (ZA, D)
        and b_in.shape == ln_in_scale.shape == ln_in_bias.shape == (D,)
        and w_gru.shape == (D + H, 3 * H)
        and gru_scale.shape == gru_bias.shape == (3 * H,)
    )
    if not shapes_ok:
        raise ValueError(
            f"fused_rssm_recurrent: shapes x {tuple(x.shape)}, h {tuple(h.shape)}, "
            f"w_in {tuple(w_in.shape)}, w_gru {tuple(w_gru.shape)} do not form one (Z+A, D, H) step"
        )
    if D % 4 or H % 4:
        raise ValueError(f"fused_rssm_recurrent: the kernel needs D % 4 == H % 4 == 0, got D={D} H={H}")
    device = x.device
    check_operands(
        "rssm", device, x=x, h=h, w_in=w_in, b_in=b_in, ln_in_scale=ln_in_scale,
        ln_in_bias=ln_in_bias, w_gru=w_gru, gru_scale=gru_scale, gru_bias=gru_bias,
    )
    out = torch.empty((B, H), device=device, dtype=torch.float32)
    if B == 0:
        return out
    lib = _build.load("rssm", _SIGNATURES)
    f32 = dict(device=device, dtype=torch.float32)
    with torch.cuda.device(device):
        bb, splits_in, kps_in = launch_plan(lib.sheeprl_rssm_blocks_per_sm, B, ZA, D, device)
        _, splits_gru, kps_gru = launch_plan(lib.sheeprl_rssm_blocks_per_sm, B, D + H, 3 * H, device)
        # one allocation for the three scratch buffers; every offset is a
        # multiple of 4 floats (D % 4 == 0), so each stays 16-byte aligned
        scratch = torch.empty(((splits_in + 1) * B * D + splits_gru * B * 3 * H,), **f32)
        parts_in, y, parts_gru = scratch.split([splits_in * B * D, B * D, splits_gru * B * 3 * H])
        tensors = (x, h, w_in, b_in, ln_in_scale, ln_in_bias, w_gru, gru_scale, gru_bias, out, parts_in, y, parts_gru)
        code = lib.sheeprl_rssm_forward(
            *(t.data_ptr() for t in tensors),
            B, ZA, D, H, bb, splits_in, kps_in, splits_gru, kps_gru, stream(device),
        )
    check_status("rssm", code)
    LAUNCHES["rssm"] += 1
    return out


class _FusedRSSM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return _launch(*args)

    @staticmethod
    def backward(ctx, grad):
        return reference_backward(rssm_recurrent_reference, ctx, grad)


def fused_rssm_recurrent(x, h, w_in, b_in, ln_in_scale, ln_in_bias, w_gru, gru_scale, gru_bias):
    """``RecurrentModel`` forward: ``GRU(h, SiLU(LN(x @ W_in + b)))``.

    Args:
        x: (..., Z+A) inputs (z ⊕ action).  h: (..., H) recurrent state;
        either may be in a lower compute dtype (cast to fp32 here).
        w_in (Z+A, D) / b_in (D,): input Dense.  ln_in_*: (D,) input LayerNorm.
        w_gru: (D+H, 3H) fused GRU kernel.  gru_*: (3H,) GRU LayerNorm.
    Returns:
        (..., H) new recurrent state, fp32.
    """
    lead = x.shape[:-1]
    # the kernel is fp32: inputs in the compute dtype are cast here, as the
    # JAX op casts them (the backward returns their gradients through the cast)
    args = (x.reshape(-1, x.shape[-1]).float(), h.reshape(-1, h.shape[-1]).float(),
            w_in, b_in, ln_in_scale, ln_in_bias, w_gru, gru_scale, gru_bias)
    if x.device.type == "cpu":
        out = rssm_recurrent_reference(*args)
    elif x.device.type == "cuda":
        out = _FusedRSSM.apply(*args) if needs_grad(args) else _launch(*args)
    else:
        raise ValueError(f"fused_rssm_recurrent: no kernel for device {x.device}")
    return out.reshape(*lead, out.shape[-1])
