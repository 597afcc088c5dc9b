"""Model building blocks (counterparts of ``sheeprl_tpu/models/models.py``).

``nn.Module`` names follow the flax modules' names, so a flax parameter path
maps onto a ``state_dict`` key by rule (see ``convert.py``).  Unlike flax,
a torch module is told its input width when it is built.  Images are NHWC
at every module boundary, as in the JAX package; the convolutions run NCHW
inside.

Every module takes the compute ``dtype`` of the precision policy, as the
flax modules do: parameters stay fp32, and :class:`Dense`, :class:`Conv` and
:class:`ConvTranspose` cast their input, weight and bias to ``dtype`` at call
time (flax's ``nn.Dense(dtype=..., param_dtype=float32)``), so gradients
reach the fp32 parameters through the casts.  :class:`LayerNorm` computes in
fp32 and returns ``dtype``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

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


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype``: input, weight and bias are cast
    at call time (a no-op in fp32)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        return F.linear(x.to(d), self.weight.to(d), None if self.bias is None else self.bias.to(d))


class Conv(nn.Conv2d):
    """``nn.Conv2d`` computing in ``dtype`` (see :class:`Dense`)."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        return self._conv_forward(x.to(d), self.weight.to(d), None if self.bias is None else self.bias.to(d))


class ConvTranspose(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in ``dtype`` (see :class:`Dense`)."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        return F.conv_transpose2d(x.to(d), self.weight.to(d), None if self.bias is None else self.bias.to(d),
                                  self.stride, self.padding, self.output_padding, self.groups, self.dilation)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, computed in fp32, output cast to
    ``dtype`` (the compute dtype, not the input's)."""

    def __init__(self, features: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(), self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


class LayerNormGRUCell(nn.Module):
    """Hafner-variant GRU cell: LayerNorm on the fused input/recurrent
    projection and a ``-1`` bias on the update gate.

    ``use_pallas`` keeps the JAX flag's name and parameter layout (flat
    ``fused_kernel`` (D+H, 3H) in (in, out) order, ``ln_scale``, ``ln_bias``)
    and runs the fused kernel of ``ops/gru.py`` (fp32 inside; its output is
    cast to ``dtype``); otherwise the cell is a bias-free :class:`Dense` +
    :class:`LayerNorm` with the gates in ``dtype``, the flax path.
    """

    def __init__(self, input_size: int, units: int, layer_norm: bool = True, use_pallas: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.units = units
        self.layer_norm = layer_norm
        self.use_pallas = use_pallas and layer_norm
        self.compute_dtype = dtype
        d_in = input_size + units
        if self.use_pallas:
            self.fused_kernel = nn.Parameter(variance_scaling_(torch.empty(d_in, 3 * units), d_in, 3 * units, "fan_in"))
            self.ln_scale = nn.Parameter(torch.ones(3 * units))
            self.ln_bias = nn.Parameter(torch.zeros(3 * units))
        else:
            self.fused = Dense(d_in, 3 * units, bias=not layer_norm, dtype=dtype)
            if layer_norm:
                self.ln = LayerNorm(3 * units, dtype=dtype)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        d = self.compute_dtype
        if self.use_pallas:
            new_h = fused_layernorm_gru(x, h, self.fused_kernel, self.ln_scale, self.ln_bias).to(d)
            return new_h, new_h
        parts = self.fused(torch.cat([x.to(d), h.to(d)], dim=-1))
        if self.layer_norm:
            parts = self.ln(parts)
        reset, cand, update = torch.chunk(parts, 3, dim=-1)
        reset = torch.sigmoid(reset)
        cand = torch.tanh(reset * cand)
        update = torch.sigmoid(update - 1.0)
        new_h = update * cand + (1.0 - update) * h.to(d)
        return new_h, new_h


def lecun_init_(layer: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """flax's default Dense/Conv init in place: a ``lecun_normal`` kernel
    (fan-in truncated normal, fan_in counting the receptive field) and a
    zero bias."""
    w = layer.weight
    variance_scaling_(w, w[0].numel(), w.shape[0] * w[0][0].numel(), "fan_in", generator)
    if layer.bias is not None:
        with torch.no_grad():
            layer.bias.zero_()


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``padding="SAME"`` on one axis: ``(low, high)`` with the total
    ``max((ceil(size / stride) - 1) * stride + kernel - size, 0)`` and the
    odd pixel on the high side (84 -> 42 -> 21 -> 11 pads (1, 1), (1, 1),
    (1, 2) with kernel 4, stride 2)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class MLP(nn.Module):
    """Dense stack: ``dense_{i}`` → optional ``ln_{i}`` → activation, then an
    optional linear ``head``."""

    def __init__(self, input_dim: int, hidden_sizes: Sequence[int] = (), output_dim: Optional[int] = None,
                 activation: Union[str, Activation] = "tanh", layer_norm: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = get_activation(activation)
        self.layer_norm = layer_norm
        self.n_hidden = len(hidden_sizes)
        self.compute_dtype = dtype
        d = input_dim
        for i, size in enumerate(hidden_sizes):
            self.add_module(f"dense_{i}", Dense(d, size, dtype=dtype))
            if layer_norm:
                self.add_module(f"ln_{i}", LayerNorm(size, dtype=dtype))
            d = size
        self.head = Dense(d, output_dim, dtype=dtype) if output_dim is not None else None
        self.out_features = output_dim if output_dim is not None else d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        for i in range(self.n_hidden):
            x = getattr(self, f"dense_{i}")(x)
            if self.layer_norm:
                x = getattr(self, f"ln_{i}")(x)
            x = self.act(x)
        return self.head(x) if self.head is not None else x

    def init_weights(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun_init_(m, generator)
            elif isinstance(m, LayerNorm):
                with torch.no_grad():
                    m.weight.fill_(1.0)
                    m.bias.zero_()


class CNN(nn.Module):
    """``conv_{i}`` stack over NHWC images with XLA's SAME padding, each
    followed by the activation; the output is flattened in NHWC order, as
    flax flattens it."""

    def __init__(self, in_shape: Tuple[int, int, int], channels: Sequence[int], kernel_size: int = 3,
                 stride: int = 2, activation: Union[str, Activation] = "relu", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = get_activation(activation)
        self.n = len(channels)
        self.compute_dtype = dtype
        h, w, c_in = in_shape
        self.pads = []
        for i, c in enumerate(channels):
            (top, bottom), (left, right) = same_padding(h, kernel_size, stride), same_padding(w, kernel_size, stride)
            self.pads.append((left, right, top, bottom))
            self.add_module(f"conv_{i}", Conv(c_in, c, kernel_size, stride=stride, dtype=dtype))
            h, w, c_in = -(-h // stride), -(-w // stride), c
        self.out_shape = (h, w, c_in)
        self.out_features = h * w * c_in

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-3]
        x = x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2).to(self.compute_dtype)
        for i in range(self.n):
            x = self.act(getattr(self, f"conv_{i}")(F.pad(x, self.pads[i])))
        return x.permute(0, 2, 3, 1).reshape(*lead, -1)

    def init_weights(self, generator: torch.Generator) -> None:
        for i in range(self.n):
            lecun_init_(getattr(self, f"conv_{i}"), generator)


class MultiEncoder(nn.Module):
    """The ``cnn_keys`` images concatenated on channels through one
    :class:`CNN` (kernel 4, stride 2) and an optional ``cnn_proj`` + act, the
    ``mlp_keys`` vectors concatenated through one :class:`MLP` and an optional
    ``mlp_proj`` + act; the features concatenated, images first.

    ``cnn_shapes``: key → NHWC shape (frame stacks merged into channels);
    ``mlp_shapes``: key → flat width."""

    def __init__(self, cnn_keys: Sequence[str], mlp_keys: Sequence[str], cnn_shapes: Dict[str, Tuple[int, int, int]],
                 mlp_shapes: Dict[str, int], cnn_channels: Sequence[int] = (32, 64, 128, 256),
                 cnn_features_dim: Optional[int] = None, mlp_sizes: Sequence[int] = (256, 256),
                 mlp_layer_norm: bool = False, mlp_features_dim: Optional[int] = None,
                 activation: Union[str, Activation] = "silu", dtype: torch.dtype = torch.float32):
        super().__init__()
        if not cnn_keys and not mlp_keys:
            raise ValueError("MultiEncoder needs at least one cnn or mlp key")
        self.cnn_keys, self.mlp_keys = tuple(cnn_keys), tuple(mlp_keys)
        self.act = get_activation(activation)
        self.cnn_proj = self.mlp_proj = None
        self.out_features = 0
        if self.cnn_keys:
            h, w, _ = cnn_shapes[self.cnn_keys[0]]
            c = sum(cnn_shapes[k][-1] for k in self.cnn_keys)
            self.cnn_encoder = CNN((h, w, c), cnn_channels, kernel_size=4, stride=2, activation=activation,
                                   dtype=dtype)
            d = self.cnn_encoder.out_features
            if cnn_features_dim:
                self.cnn_proj = Dense(d, cnn_features_dim, dtype=dtype)
                d = cnn_features_dim
            self.out_features += d
        if self.mlp_keys:
            self.mlp_encoder = MLP(sum(mlp_shapes[k] for k in self.mlp_keys), mlp_sizes, activation=activation,
                                   layer_norm=mlp_layer_norm, dtype=dtype)
            d = self.mlp_encoder.out_features
            if mlp_features_dim:
                self.mlp_proj = Dense(d, mlp_features_dim, dtype=dtype)
                d = mlp_features_dim
            self.out_features += d

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        feats = []
        if self.cnn_keys:
            y = self.cnn_encoder(torch.cat([obs[k] for k in self.cnn_keys], dim=-1))
            feats.append(self.act(self.cnn_proj(y)) if self.cnn_proj is not None else y)
        if self.mlp_keys:
            y = self.mlp_encoder(torch.cat([obs[k] for k in self.mlp_keys], dim=-1))
            feats.append(self.act(self.mlp_proj(y)) if self.mlp_proj is not None else y)
        return torch.cat(feats, dim=-1)

    def init_weights(self, generator: torch.Generator) -> None:
        for name in ("cnn_encoder", "mlp_encoder"):
            if hasattr(self, name):
                getattr(self, name).init_weights(generator)
        for proj in (self.cnn_proj, self.mlp_proj):
            if proj is not None:
                lecun_init_(proj, generator)


class StackedLinear(nn.Module):
    """``n`` dense layers side by side, the layout of a flax params-vmapped
    ``Dense``: ``kernel`` (n, in, out), ``bias`` (n, out).  ``x`` (M, in) or
    (n, M, in) → (n, M, out), one batched product in ``dtype``."""

    def __init__(self, n: int, in_features: int, out_features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.kernel = nn.Parameter(torch.empty(n, in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(n, out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        return torch.matmul(x.to(d), self.kernel.to(d)) + self.bias.to(d)[:, None, :]

    def init_weights(self, generator: torch.Generator, mode: str = "fan_in") -> None:
        """Each member's kernel as flax's default Dense init (``fan_in``) or
        Hafner's (``fan_avg``); zero biases."""
        with torch.no_grad():
            for k in self.kernel:
                variance_scaling_(k, *k.shape, mode, generator)
            self.bias.zero_()


class StackedLayerNorm(nn.Module):
    """``n`` fp32 LayerNorms side by side over (n, M, features):
    ``weight``, ``bias`` (n, features); the output in ``dtype``."""

    def __init__(self, n: int, features: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(n, features))
        self.bias = nn.Parameter(torch.zeros(n, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], eps=self.eps)
        return (y * self.weight[:, None, :] + self.bias[:, None, :]).to(self.compute_dtype)


def deconv_init_(layer: nn.ConvTranspose2d, generator: Optional[torch.Generator] = None) -> None:
    """flax's default ConvTranspose init: ``lecun_normal`` over a fan-in of
    ``kH·kW·in`` (torch's weight is (in, out, kH, kW)), zero bias."""
    w = layer.weight
    variance_scaling_(w, w.shape[0] * w[0][0].numel(), w.shape[1] * w[0][0].numel(), "fan_in", generator)
    if layer.bias is not None:
        with torch.no_grad():
            layer.bias.zero_()


class DeCNN(nn.Module):
    """``deconv_{i}`` stack of transposed convolutions over NHWC images, each
    but the last followed by the activation.  flax's ``ConvTranspose`` with
    ``padding="SAME"``, kernel 4 and stride 2 doubles the size: torch's
    ``padding=1`` with the kernel flipped spatially (``convert.py`` flips
    it), the rule of the DreamerV3 decoder.  Only that kernel and stride are
    supported."""

    def __init__(self, in_channels: int, channels: Sequence[int], kernel_size: int = 4, stride: int = 2,
                 activation: Union[str, Activation] = "relu", dtype: torch.dtype = torch.float32):
        super().__init__()
        if (kernel_size, stride) != (4, 2):
            raise ValueError(f"DeCNN supports kernel 4, stride 2 (SAME), got kernel {kernel_size}, stride {stride}")
        self.act = get_activation(activation)
        self.n = len(channels)
        c_in = in_channels
        for i, c in enumerate(channels):
            self.add_module(f"deconv_{i}", ConvTranspose(c_in, c, kernel_size, stride=stride, padding=1, dtype=dtype))
            c_in = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-3]
        x = x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2)
        for i in range(self.n):
            x = getattr(self, f"deconv_{i}")(x)
            if i < self.n - 1:
                x = self.act(x)
        x = x.permute(0, 2, 3, 1)
        return x.reshape(*lead, *x.shape[1:])

    def init_weights(self, generator: torch.Generator) -> None:
        for i in range(self.n):
            deconv_init_(getattr(self, f"deconv_{i}"), generator)


class MultiDecoder(nn.Module):
    """Features → per-key reconstructions, the inverse of
    :class:`MultiEncoder`.  The images: a ``cnn_in`` Dense to ``h0·w0·stem``
    and the activation, reshaped to (h0, w0, stem) with ``h0 = H /
    2**(len(cnn_channels) + 1)``, then a :class:`DeCNN` over ``cnn_channels +
    (total channels,)`` (no activation after the last), split per key on
    channels, NHWC.  The vectors: an :class:`MLP` trunk, then a ``head_<k>``
    Dense per key."""

    def __init__(self, features_dim: int, cnn_keys: Sequence[str], mlp_keys: Sequence[str],
                 cnn_shapes: Dict[str, Tuple[int, int, int]], mlp_shapes: Dict[str, int],
                 cnn_channels: Sequence[int] = (64, 32), cnn_stem_channels: int = 128,
                 mlp_sizes: Sequence[int] = (256, 256), kernel_size: int = 4, stride: int = 2,
                 activation: Union[str, Activation] = "relu", dtype: torch.dtype = torch.float32):
        super().__init__()
        if not cnn_keys and not mlp_keys:
            raise ValueError("MultiDecoder needs at least one cnn or mlp key")
        self.cnn_keys, self.mlp_keys = tuple(cnn_keys), tuple(mlp_keys)
        self.cnn_shapes = {k: tuple(cnn_shapes[k]) for k in self.cnn_keys}
        self.act = get_activation(activation)
        if self.cnn_keys:
            n_deconvs = len(cnn_channels) + 1
            h, w, _ = self.cnn_shapes[self.cnn_keys[0]]
            self.stem = (h // 2**n_deconvs, w // 2**n_deconvs, cnn_stem_channels)
            total_c = sum(self.cnn_shapes[k][-1] for k in self.cnn_keys)
            self.cnn_in = Dense(features_dim, self.stem[0] * self.stem[1] * cnn_stem_channels, dtype=dtype)
            self.decnn = DeCNN(cnn_stem_channels, (*cnn_channels, total_c), kernel_size, stride, activation, dtype)
        if self.mlp_keys:
            self.mlp = MLP(features_dim, mlp_sizes, activation=activation, dtype=dtype)
            for k in self.mlp_keys:
                # the heads emit fp32 whatever the compute dtype, as in JAX
                self.add_module(f"head_{k}", Dense(self.mlp.out_features, int(mlp_shapes[k])))

    def forward(self, features: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        if self.cnn_keys:
            x = self.act(self.cnn_in(features))
            x = self.decnn(x.reshape(*x.shape[:-1], *self.stem))
            start = 0
            for k in self.cnn_keys:
                c = self.cnn_shapes[k][-1]
                out[k] = x[..., start:start + c]
                start += c
        if self.mlp_keys:
            trunk = self.mlp(features)
            for k in self.mlp_keys:
                out[k] = getattr(self, f"head_{k}")(trunk)
        return out

    def init_weights(self, generator: torch.Generator) -> None:
        if self.cnn_keys:
            lecun_init_(self.cnn_in, generator)
            self.decnn.init_weights(generator)
        if self.mlp_keys:
            self.mlp.init_weights(generator)
            for k in self.mlp_keys:
                lecun_init_(getattr(self, f"head_{k}"), generator)
