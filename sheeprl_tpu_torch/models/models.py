"""Model building blocks (counterparts of ``sheeprl_tpu/models/models.py``).

``nn.Module`` names follow the flax modules' names, so a flax parameter path
maps onto a ``state_dict`` key by rule (see ``convert.py``).  Unlike flax,
a torch module is told its input width when it is built.
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from sheeprl_tpu_torch.ops.gru import fused_layernorm_gru

Activation = Callable[[torch.Tensor], torch.Tensor]


def get_activation(name: Union[str, Activation, None]) -> Activation:
    if name is None:
        return lambda x: x
    if callable(name):
        return name
    table = {
        "relu": F.relu,
        "tanh": torch.tanh,
        "silu": F.silu,
        "swish": F.silu,
        "gelu": F.gelu,
        "elu": F.elu,
        "leaky_relu": F.leaky_relu,
        "sigmoid": torch.sigmoid,
        "identity": lambda x: x,
    }
    if name not in table:
        raise ValueError(f"Unknown activation '{name}'")
    return table[name]


def variance_scaling_(
    t: torch.Tensor, fan_in: int, fan_out: int, mode: str, generator: torch.Generator = None
) -> torch.Tensor:
    """flax's ``variance_scaling(1.0, mode, "truncated_normal")`` in place:
    a normal truncated at two standard deviations, scaled so the variance is
    ``1 / fan`` (``fan_in``, or ``fan_avg`` = the mean of both fans)."""
    fan = fan_in if mode == "fan_in" else (fan_in + fan_out) / 2.0
    # 0.8796... is the std of a standard normal truncated to [-2, 2]
    std = (1.0 / max(1.0, fan)) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, computed in fp32, output cast back to
    the input's dtype."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(), self.bias.float(), self.eps)
        return y.to(x.dtype)


class LayerNormGRUCell(nn.Module):
    """Hafner-variant GRU cell: LayerNorm on the fused input/recurrent
    projection and a ``-1`` bias on the update gate.

    ``use_pallas`` keeps the JAX flag's name and parameter layout (flat
    ``fused_kernel`` (D+H, 3H) in (in, out) order, ``ln_scale``, ``ln_bias``)
    and runs the fused kernel of ``ops/gru.py``; otherwise the cell is a
    bias-free ``Linear`` + :class:`LayerNorm`, the flax path.
    """

    def __init__(self, input_size: int, units: int, layer_norm: bool = True, use_pallas: bool = False):
        super().__init__()
        self.units = units
        self.layer_norm = layer_norm
        self.use_pallas = use_pallas and layer_norm
        d_in = input_size + units
        if self.use_pallas:
            self.fused_kernel = nn.Parameter(variance_scaling_(torch.empty(d_in, 3 * units), d_in, 3 * units, "fan_in"))
            self.ln_scale = nn.Parameter(torch.ones(3 * units))
            self.ln_bias = nn.Parameter(torch.zeros(3 * units))
        else:
            self.fused = nn.Linear(d_in, 3 * units, bias=not layer_norm)
            if layer_norm:
                self.ln = LayerNorm(3 * units)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.use_pallas:
            new_h = fused_layernorm_gru(x, h, self.fused_kernel, self.ln_scale, self.ln_bias).to(x.dtype)
            return new_h, new_h
        parts = self.fused(torch.cat([x, h.to(x.dtype)], dim=-1))
        if self.layer_norm:
            parts = self.ln(parts)
        reset, cand, update = torch.chunk(parts, 3, dim=-1)
        reset = torch.sigmoid(reset)
        cand = torch.tanh(reset * cand)
        update = torch.sigmoid(update - 1.0)
        new_h = update * cand + (1.0 - update) * h.to(x.dtype)
        return new_h, new_h
