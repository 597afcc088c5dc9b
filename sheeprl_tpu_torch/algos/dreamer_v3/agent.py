"""DreamerV3 agent (PyTorch): world model, actor, critic.

Counterpart of ``sheeprl_tpu/algos/dreamer_v3/agent.py``.  Module and
parameter names follow the flax modules, so ``convert.py`` maps a JAX
parameter tree onto these ``state_dict``s by rule.  Images are NHWC at the
public boundary (as in JAX) and NCHW inside the convolutions; the encoder
flattens its last feature map in H, W, C order, as flax does.

``RecurrentModel`` keeps both JAX kernel flags and their parameter layouts:
``fused_pallas`` runs the whole recurrent step as the CUDA kernel of
``ops/rssm.py``, ``use_pallas`` only the GRU cell (``ops/gru.py``).  With
both off it is the ordinary module path (Linear + LayerNorm + GRU cell).

Every module takes the fabric's compute ``dtype`` where the flax module
does: products and convolutions run in it, with fp32 LayerNorm islands, fp32
heads (actor, critic, reward, continue, the MLP decoder's heads and the last
deconvolution) and an fp32 recurrent state carried between steps.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from sheeprl_tpu_torch.envs.minedojo import FN_CRAFT, FN_DESTROY, FN_EQUIP, FN_PLACE, N_MOVEMENT_ACTIONS
from sheeprl_tpu_torch.models.models import (
    Conv,
    ConvTranspose,
    Dense,
    LayerNorm,
    LayerNormGRUCell,
    StackedLayerNorm,
    StackedLinear,
    get_activation,
    variance_scaling_,
)
from sheeprl_tpu_torch.ops.rssm import fused_rssm_recurrent
from sheeprl_tpu_torch.utils.distribution import Normal, OneHotCategorical, gumbel_noise
from sheeprl_tpu_torch.utils.utils import symlog


def _fans(weight: torch.Tensor, transposed: bool = False) -> Tuple[int, int]:
    """(fan_in, fan_out) of a torch Linear / Conv2d / ConvTranspose2d weight,
    counted as flax counts them on the matching kernel."""
    if weight.dim() == 2:
        return weight.shape[1], weight.shape[0]
    receptive = weight[0][0].numel()
    n_in, n_out = (weight.shape[0], weight.shape[1]) if transposed else (weight.shape[1], weight.shape[0])
    return n_in * receptive, n_out * receptive


def _trunk_(layer: nn.Module, g: torch.Generator, zero: bool = False, mode: str = "fan_avg") -> None:
    """Hafner init: fan-avg truncated normal (or zeros) kernel, zero bias."""
    with torch.no_grad():
        if zero:
            layer.weight.zero_()
        else:
            fan_in, fan_out = _fans(layer.weight, isinstance(layer, nn.ConvTranspose2d))
            variance_scaling_(layer.weight, fan_in, fan_out, mode, g)
        if layer.bias is not None:
            layer.bias.zero_()


def _ln_(ln: LayerNorm) -> None:
    with torch.no_grad():
        ln.weight.fill_(1.0)
        ln.bias.zero_()


class DreamerMLP(nn.Module):
    """Linear → LayerNorm(1e-3) → act stack in ``dtype``, with an optional
    fp32 head."""

    def __init__(
        self,
        in_features: int,
        units: int,
        layers: int,
        output_dim: Optional[int] = None,
        act: str = "silu",
        layer_norm: bool = True,
        zero_head: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.layers = layers
        self.layer_norm = layer_norm
        self.zero_head = zero_head
        self.compute_dtype = dtype
        self.act = get_activation(act)
        for i in range(layers):
            self.add_module(f"dense_{i}", Dense(in_features if i == 0 else units, units, dtype=dtype))
            if layer_norm:
                self.add_module(f"ln_{i}", LayerNorm(units, eps=1e-3, dtype=dtype))
        self.head = Dense(units if layers else in_features, output_dim) if output_dim is not None else None
        self.out_features = output_dim if output_dim is not None else (units if layers else in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        for i in range(self.layers):
            x = getattr(self, f"dense_{i}")(x)
            if self.layer_norm:
                x = getattr(self, f"ln_{i}")(x)
            x = self.act(x)
        if self.head is not None:
            x = self.head(x)
        return x

    def init_weights(self, g: torch.Generator) -> None:
        for i in range(self.layers):
            _trunk_(getattr(self, f"dense_{i}"), g)
            if self.layer_norm:
                _ln_(getattr(self, f"ln_{i}"))
        if self.head is not None:
            _trunk_(self.head, g, zero=self.zero_head)


class Ensembles(nn.Module):
    """``n`` :class:`DreamerMLP` stacks (Dense → LayerNorm → act, then a
    head) as one module of stacked weights, the layout of the JAX package's
    params-vmapped ``Ensembles`` (member axis first): ``x`` (M, in) →
    (n, M, output_dim) as batched products."""

    def __init__(self, n: int, in_features: int, units: int, layers: int, output_dim: int, act: str = "silu",
                 layer_norm: bool = True):
        super().__init__()
        self.n, self.layers, self.layer_norm = n, layers, layer_norm
        self.act = get_activation(act)
        self.ens = nn.Module()
        for i in range(layers):
            self.ens.add_module(f"dense_{i}", StackedLinear(n, in_features if i == 0 else units, units))
            if layer_norm:
                self.ens.add_module(f"ln_{i}", StackedLayerNorm(n, units, eps=1e-3))
        self.ens.add_module("head", StackedLinear(n, units if layers else in_features, output_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.layers):
            x = getattr(self.ens, f"dense_{i}")(x)
            if self.layer_norm:
                x = getattr(self.ens, f"ln_{i}")(x)
            x = self.act(x)
        return self.ens.head(x)

    def init_weights(self, g: torch.Generator) -> None:
        for i in range(self.layers):
            getattr(self.ens, f"dense_{i}").init_weights(g, "fan_avg")
        self.ens.head.init_weights(g, "fan_avg")


def _nhwc_ln(ln: LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the channels at each pixel of an NCHW tensor."""
    return ln(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class Encoder(nn.Module):
    """CNN (four stride-2 stages) + MLP (symlog inputs) encoder."""

    def __init__(
        self,
        cnn_keys: Sequence[str],
        mlp_keys: Sequence[str],
        cnn_shapes: Dict[str, Tuple[int, int, int]],
        mlp_shapes: Dict[str, int],
        cnn_mult: int = 32,
        mlp_units: int = 512,
        mlp_layers: int = 2,
        act: str = "silu",
        layer_norm: bool = True,
        symlog_inputs: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.cnn_keys = tuple(cnn_keys)
        self.mlp_keys = tuple(mlp_keys)
        self.layer_norm = layer_norm
        self.symlog_inputs = symlog_inputs
        self.compute_dtype = dtype
        self.act = get_activation(act)
        self.out_features = 0
        if self.cnn_keys:
            h, w, _ = cnn_shapes[self.cnn_keys[0]]
            if h % 16 or w % 16:
                raise ValueError(f"Encoder: image {h}x{w} must be divisible by 16 (four stride-2 stages)")
            c_in = sum(cnn_shapes[k][-1] for k in self.cnn_keys)
            stages = [cnn_mult * m for m in (1, 2, 4, 8)]
            for i, c in enumerate(stages):
                # flax "SAME" with k=4, s=2 on an even size pads one pixel each side
                self.add_module(f"conv_{i}", Conv(c_in, c, 4, stride=2, padding=1, bias=not layer_norm, dtype=dtype))
                if layer_norm:
                    self.add_module(f"cnn_ln_{i}", LayerNorm(c, eps=1e-3, dtype=dtype))
                c_in = c
            self.out_features += (h // 16) * (w // 16) * stages[-1]
        if self.mlp_keys:
            self.mlp_encoder = DreamerMLP(
                sum(mlp_shapes[k] for k in self.mlp_keys), mlp_units, mlp_layers, act=act, layer_norm=layer_norm,
                dtype=dtype,
            )
            self.out_features += self.mlp_encoder.out_features

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        feats = []
        if self.cnn_keys:
            x = torch.cat([obs[k] for k in self.cnn_keys], dim=-1).to(self.compute_dtype)
            lead = x.shape[:-3]
            x = x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2)
            for i in range(4):
                x = getattr(self, f"conv_{i}")(x)
                if self.layer_norm:
                    x = _nhwc_ln(getattr(self, f"cnn_ln_{i}"), x)
                x = self.act(x)
            feats.append(x.permute(0, 2, 3, 1).reshape(*lead, -1))
        if self.mlp_keys:
            v = torch.cat([obs[k] for k in self.mlp_keys], dim=-1)
            if self.symlog_inputs:
                v = symlog(v)
            feats.append(self.mlp_encoder(v))
        return torch.cat(feats, dim=-1)

    def init_weights(self, g: torch.Generator) -> None:
        if self.cnn_keys:
            for i in range(4):
                _trunk_(getattr(self, f"conv_{i}"), g)
                if self.layer_norm:
                    _ln_(getattr(self, f"cnn_ln_{i}"))
        if self.mlp_keys:
            self.mlp_encoder.init_weights(g)


class Decoder(nn.Module):
    """Latent → transposed-CNN stages + MLP heads; per-key reconstruction means."""

    def __init__(
        self,
        latent_size: int,
        cnn_keys: Sequence[str],
        mlp_keys: Sequence[str],
        cnn_shapes: Dict[str, Tuple[int, int, int]],
        mlp_shapes: Dict[str, int],
        cnn_mult: int = 32,
        mlp_units: int = 512,
        mlp_layers: int = 2,
        act: str = "silu",
        layer_norm: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.cnn_keys = tuple(cnn_keys)
        self.mlp_keys = tuple(mlp_keys)
        self.cnn_shapes = dict(cnn_shapes)
        self.cnn_mult = cnn_mult
        self.layer_norm = layer_norm
        self.act = get_activation(act)
        if self.cnn_keys:
            total_c = sum(self.cnn_shapes[k][-1] for k in self.cnn_keys)
            self.cnn_in = Dense(latent_size, 4 * 4 * cnn_mult * 8, dtype=dtype)
            c_in = cnn_mult * 8
            for i, c in enumerate((cnn_mult * 4, cnn_mult * 2, cnn_mult)):
                # flax ConvTranspose "SAME", k=4, s=2 doubles the size: torch padding=1
                self.add_module(
                    f"deconv_{i}",
                    ConvTranspose(c_in, c, 4, stride=2, padding=1, bias=not layer_norm, dtype=dtype),
                )
                if layer_norm:
                    self.add_module(f"cnn_ln_{i}", LayerNorm(c, eps=1e-3, dtype=dtype))
                c_in = c
            self.deconv_out = ConvTranspose(c_in, total_c, 4, stride=2, padding=1)  # fp32, as in JAX
        if self.mlp_keys:
            self.mlp_decoder = DreamerMLP(latent_size, mlp_units, mlp_layers, act=act, dtype=dtype)
            for k in self.mlp_keys:
                self.add_module(f"head_{k}", Dense(mlp_units, mlp_shapes[k]))

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        if self.cnn_keys:
            x = self.cnn_in(latent)
            lead = x.shape[:-1]
            x = x.reshape(-1, 4, 4, self.cnn_mult * 8).permute(0, 3, 1, 2)
            for i in range(3):
                x = getattr(self, f"deconv_{i}")(x)
                if self.layer_norm:
                    x = _nhwc_ln(getattr(self, f"cnn_ln_{i}"), x)
                x = self.act(x)
            x = self.deconv_out(x).permute(0, 2, 3, 1)
            x = x.reshape(*lead, *x.shape[1:])
            start = 0
            for k in self.cnn_keys:
                c = self.cnn_shapes[k][-1]
                out[k] = x[..., start : start + c]
                start += c
        if self.mlp_keys:
            trunk = self.mlp_decoder(latent)
            for k in self.mlp_keys:
                out[k] = getattr(self, f"head_{k}")(trunk)
        return out

    def init_weights(self, g: torch.Generator) -> None:
        if self.cnn_keys:
            _trunk_(self.cnn_in, g)
            for i in range(3):
                _trunk_(getattr(self, f"deconv_{i}"), g)
                if self.layer_norm:
                    _ln_(getattr(self, f"cnn_ln_{i}"))
            _trunk_(self.deconv_out, g)
        if self.mlp_keys:
            self.mlp_decoder.init_weights(g)
            for k in self.mlp_keys:
                _trunk_(getattr(self, f"head_{k}"), g)


class RecurrentModel(nn.Module):
    """(z ⊕ a) → Linear + LayerNorm(1e-3) + SiLU → LayerNorm-GRU cell.

    ``fused_pallas`` declares the flat parameters of the JAX flag
    (``in_kernel`` (Z+A, D), ``in_bias``, ``ln_scale``, ``ln_bias``,
    ``gru_kernel`` (D+H, 3H), ``gru_ln_scale``, ``gru_ln_bias``; kernels in
    (in, out) order) and runs ``fused_rssm_recurrent`` (fp32 inside), its
    output cast to ``dtype`` as JAX casts it."""

    def __init__(
        self,
        input_size: int,
        recurrent_size: int,
        dense_units: int,
        use_pallas: bool = False,
        fused_pallas: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.fused_pallas = fused_pallas
        self.compute_dtype = dtype
        D, H = dense_units, recurrent_size
        if fused_pallas:
            self.in_kernel = nn.Parameter(variance_scaling_(torch.empty(input_size, D), input_size, D, "fan_avg"))
            self.in_bias = nn.Parameter(torch.zeros(D))
            self.ln_scale = nn.Parameter(torch.ones(D))
            self.ln_bias = nn.Parameter(torch.zeros(D))
            self.gru_kernel = nn.Parameter(variance_scaling_(torch.empty(D + H, 3 * H), D + H, 3 * H, "fan_in"))
            self.gru_ln_scale = nn.Parameter(torch.ones(3 * H))
            self.gru_ln_bias = nn.Parameter(torch.zeros(3 * H))
        else:
            self.add_module("in", Dense(input_size, D, dtype=dtype))
            self.ln = LayerNorm(D, eps=1e-3, dtype=dtype)
            self.gru = LayerNormGRUCell(D, H, layer_norm=True, use_pallas=use_pallas, dtype=dtype)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        if self.fused_pallas:
            return fused_rssm_recurrent(
                x, h, self.in_kernel, self.in_bias, self.ln_scale, self.ln_bias,
                self.gru_kernel, self.gru_ln_scale, self.gru_ln_bias,
            ).to(self.compute_dtype)
        y = torch.nn.functional.silu(self.ln(getattr(self, "in")(x)))
        new_h, _ = self.gru(h, y)
        return new_h

    def init_weights(self, g: torch.Generator) -> None:
        with torch.no_grad():
            if self.fused_pallas:
                variance_scaling_(self.in_kernel, *self.in_kernel.shape, "fan_avg", g)
                variance_scaling_(self.gru_kernel, *self.gru_kernel.shape, "fan_in", g)
                for p in (self.in_bias, self.ln_bias, self.gru_ln_bias):
                    p.zero_()
                self.ln_scale.fill_(1.0)
                self.gru_ln_scale.fill_(1.0)
                return
            _trunk_(getattr(self, "in"), g)
            _ln_(self.ln)
            gru = self.gru
            # the flax cell keeps flax's default Dense init: lecun normal
            if gru.use_pallas:
                variance_scaling_(gru.fused_kernel, *gru.fused_kernel.shape, "fan_in", g)
                gru.ln_scale.fill_(1.0)
                gru.ln_bias.zero_()
            else:
                _trunk_(gru.fused, g, mode="fan_in")
                _ln_(gru.ln)


class WorldModel(nn.Module):
    """Encoder, RSSM parts, decoder, reward and continue heads."""

    def __init__(
        self,
        cnn_keys: Sequence[str],
        mlp_keys: Sequence[str],
        cnn_shapes: Dict[str, Tuple[int, int, int]],
        mlp_shapes: Dict[str, int],
        actions_dim: Sequence[int],
        cnn_mult: int = 32,
        dense_units: int = 512,
        mlp_layers: int = 2,
        recurrent_size: int = 512,
        hidden_size: int = 512,
        repr_hidden_size: int = 512,
        stochastic_size: int = 32,
        discrete_size: int = 32,
        unimix: float = 0.01,
        bins: int = 255,
        act: str = "silu",
        layer_norm: bool = True,
        symlog_inputs: bool = True,
        learnable_initial_state: bool = True,
        decoupled_rssm: bool = False,
        use_pallas_gru: bool = False,
        fused_pallas_rssm: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.stochastic_size = stochastic_size
        self.discrete_size = discrete_size
        self.stoch_flat = stochastic_size * discrete_size
        self.recurrent_size = recurrent_size
        self.unimix = unimix
        self.decoupled_rssm = decoupled_rssm
        self.learnable_initial_state = learnable_initial_state
        latent = self.stoch_flat + recurrent_size
        self.encoder = Encoder(
            cnn_keys, mlp_keys, cnn_shapes, mlp_shapes, cnn_mult=cnn_mult, mlp_units=dense_units,
            mlp_layers=mlp_layers, act=act, layer_norm=layer_norm, symlog_inputs=symlog_inputs, dtype=dtype,
        )
        self.recurrent_model = RecurrentModel(
            self.stoch_flat + int(sum(actions_dim)), recurrent_size, dense_units,
            use_pallas=use_pallas_gru, fused_pallas=fused_pallas_rssm, dtype=dtype,
        )
        embed = self.encoder.out_features
        self.representation_model = DreamerMLP(
            embed if decoupled_rssm else recurrent_size + embed, repr_hidden_size, 1,
            output_dim=self.stoch_flat, act=act, layer_norm=layer_norm, dtype=dtype,
        )
        self.transition_model = DreamerMLP(
            recurrent_size, hidden_size, 1, output_dim=self.stoch_flat, act=act, layer_norm=layer_norm, dtype=dtype
        )
        self.observation_model = Decoder(
            latent, cnn_keys, mlp_keys, cnn_shapes, mlp_shapes, cnn_mult=cnn_mult,
            mlp_units=dense_units, mlp_layers=mlp_layers, act=act, layer_norm=layer_norm, dtype=dtype,
        )
        self.reward_model = DreamerMLP(
            latent, dense_units, mlp_layers, output_dim=bins, act=act, layer_norm=layer_norm, zero_head=True,
            dtype=dtype,
        )
        self.continue_model = DreamerMLP(
            latent, dense_units, mlp_layers, output_dim=1, act=act, layer_norm=layer_norm, zero_head=True,
            dtype=dtype,
        )
        if learnable_initial_state:
            self.initial_recurrent = nn.Parameter(torch.zeros(recurrent_size))

    def init_weights(self, g: torch.Generator) -> None:
        for name in ("encoder", "recurrent_model", "representation_model", "transition_model",
                     "observation_model", "reward_model", "continue_model"):
            getattr(self, name).init_weights(g)
        if self.learnable_initial_state:
            with torch.no_grad():
                self.initial_recurrent.zero_()

    # ---- pieces -----------------------------------------------------------
    def encode(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.encoder(obs)

    def initial_state(self, batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(h0, z0): tanh of the learnable recurrent init; z0 = prior mode of h0."""
        if self.learnable_initial_state:
            h0 = torch.tanh(self.initial_recurrent.float())
        else:
            h0 = torch.zeros(self.recurrent_size, device=self.transition_model.head.weight.device)
        h0 = h0.expand(batch, self.recurrent_size)
        prior_logits = self._logits_reshape(self.transition_model(h0))
        z0 = OneHotCategorical(prior_logits, unimix=self.unimix).mode()
        return h0, z0.reshape(batch, self.stoch_flat)

    def _logits_reshape(self, logits: torch.Tensor) -> torch.Tensor:
        return logits.reshape(*logits.shape[:-1], self.stochastic_size, self.discrete_size)

    def latent_noise(self, lead: Sequence[int], generator: torch.Generator) -> torch.Tensor:
        """The Gumbel noise of ``lead``-shaped latent samples: (*lead, stoch, discrete)."""
        return gumbel_noise((*lead, self.stochastic_size, self.discrete_size), generator, generator.device)

    def posterior_noise(self, batch: int, generator: torch.Generator) -> torch.Tensor:
        """The Gumbel noise one posterior sample of ``batch`` rows consumes."""
        return self.latent_noise((batch,), generator)

    def dynamic(self, prev_h, prev_z, prev_action, embed, is_first, generator: torch.Generator):
        """One posterior step; the sample's noise is drawn from ``generator``.
        Returns (h, z, posterior_logits, prior_logits)."""
        noise = self.posterior_noise(prev_h.shape[0], generator)
        return self.dynamic_noise(prev_h, prev_z, prev_action, embed, is_first, noise)

    def dynamic_noise(self, prev_h, prev_z, prev_action, embed, is_first, noise: torch.Tensor):
        """:meth:`dynamic` with pre-drawn Gumbel noise of the posterior
        logits' shape: resets (h, z, a) at episode starts, advances the
        recurrent model, and samples the posterior (straight-through)."""
        B = prev_h.shape[0]
        h0, z0 = self.initial_state(B)
        mask = 1.0 - is_first
        prev_h = prev_h * mask + h0 * is_first
        prev_z = prev_z * mask + z0 * is_first
        prev_action = prev_action * mask
        h = self.recurrent_model(prev_h, torch.cat([prev_z, prev_action], dim=-1)).float()
        prior_logits = self._logits_reshape(self.transition_model(h))
        post_in = embed if self.decoupled_rssm else torch.cat([h, embed], dim=-1)
        post_logits = self._logits_reshape(self.representation_model(post_in))
        z = OneHotCategorical(post_logits, unimix=self.unimix).rsample_from_noise(noise)
        return h, z.reshape(B, self.stoch_flat), post_logits, prior_logits

    def posterior_decoupled(self, embed: torch.Tensor) -> torch.Tensor:
        """DecoupledRSSM posterior logits from the embedding alone, for every
        time step in one batched pass."""
        return self._logits_reshape(self.representation_model(embed))

    def recurrent_prior(self, prev_h, prev_z, prev_action, is_first):
        """The sequential part of the DecoupledRSSM: reset at episode starts,
        advance the recurrent model and predict the prior.  Returns
        (h, prior_logits)."""
        B = prev_h.shape[0]
        h0, z0 = self.initial_state(B)
        mask = 1.0 - is_first
        prev_h = prev_h * mask + h0 * is_first
        prev_z = prev_z * mask + z0 * is_first
        prev_action = prev_action * mask
        h = self.recurrent_model(prev_h, torch.cat([prev_z, prev_action], dim=-1)).float()
        return h, self._logits_reshape(self.transition_model(h))

    def imagination(self, prev_h, prev_z, action, generator: torch.Generator):
        """One prior step; the sample's noise is drawn from ``generator``."""
        return self.imagination_noise(prev_h, prev_z, action, self.posterior_noise(prev_h.shape[0], generator))

    def imagination_noise(self, prev_h, prev_z, action, noise: torch.Tensor):
        """:meth:`imagination` with pre-drawn Gumbel noise (B, stoch, discrete)."""
        h = self.recurrent_model(prev_h, torch.cat([prev_z, action], dim=-1)).float()
        prior_logits = self._logits_reshape(self.transition_model(h))
        z = OneHotCategorical(prior_logits, unimix=self.unimix).rsample_from_noise(noise)
        return h, z.reshape(z.shape[0], self.stoch_flat)

    def decode(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.observation_model(latent)

    def reward_logits(self, latent: torch.Tensor) -> torch.Tensor:
        return self.reward_model(latent)

    def continue_logits(self, latent: torch.Tensor) -> torch.Tensor:
        return self.continue_model(latent)


class Actor(nn.Module):
    """Latent → action distribution: per-branch unimix categoricals, or a
    Normal with sigmoid-squashed std and a scaled clip."""

    def __init__(
        self,
        latent_size: int,
        actions_dim: Sequence[int],
        is_continuous: bool,
        dense_units: int = 512,
        mlp_layers: int = 2,
        act: str = "silu",
        layer_norm: bool = True,
        unimix: float = 0.01,
        min_std: float = 0.1,
        max_std: float = 1.0,
        init_std: float = 2.0,
        action_clip: float = 1.0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.actions_dim = tuple(int(d) for d in actions_dim)
        self.is_continuous = is_continuous
        self.unimix = unimix
        self.min_std, self.max_std, self.init_std = min_std, max_std, init_std
        self.action_clip = action_clip
        self.trunk = DreamerMLP(latent_size, dense_units, mlp_layers, act=act, layer_norm=layer_norm, dtype=dtype)
        self.head = Dense(dense_units, sum(self.actions_dim) * (2 if is_continuous else 1))

    def forward(self, latent: torch.Tensor) -> torch.Tensor:
        return self.head(self.trunk(latent))

    def init_weights(self, g: torch.Generator) -> None:
        self.trunk.init_weights(g)
        _trunk_(self.head, g)

    def dists(self, head_out: torch.Tensor) -> List[Any]:
        if self.is_continuous:
            mean, std_raw = torch.chunk(head_out, 2, dim=-1)
            std = (self.max_std - self.min_std) * torch.sigmoid(std_raw + self.init_std) + self.min_std
            return [Normal(torch.tanh(mean), std, event_dims=1)]
        dists, start = [], 0
        for d in self.actions_dim:
            dists.append(OneHotCategorical(head_out[..., start : start + d], unimix=self.unimix))
            start += d
        return dists

    def sample_noise(self, lead: Sequence[int], generator: torch.Generator) -> List[torch.Tensor]:
        """The draws one :meth:`sample` of a ``lead``-shaped batch consumes:
        one standard normal (``(*lead, A)``) for continuous actions, else one
        Gumbel per branch (``(*lead, d)``)."""
        if self.is_continuous:
            return [Normal.sample_noise((*lead, self.actions_dim[0]), generator, generator.device)]
        return [gumbel_noise((*lead, d), generator, generator.device) for d in self.actions_dim]

    def sample(self, head_out: torch.Tensor, generator: torch.Generator, greedy: bool = False) -> torch.Tensor:
        noise = () if greedy else self.sample_noise(head_out.shape[:-1], generator)
        return self.sample_from_noise(head_out, noise, greedy)

    def sample_from_noise(self, head_out: torch.Tensor, noise: Sequence[torch.Tensor], greedy: bool = False):
        """:meth:`sample` with the draws of :meth:`sample_noise`.  A continuous
        sample is clipped by a scale that carries no gradient, so saturated
        samples keep d(action)/d(params)."""
        dists = self.dists(head_out)
        if self.is_continuous:
            a = dists[0].mode() if greedy else dists[0].sample_from_noise(noise[0])
            if self.action_clip > 0:
                scale = (self.action_clip / torch.clamp(torch.abs(a), min=self.action_clip)).detach()
                a = a * scale
            return a
        if greedy:
            return torch.cat([d.mode() for d in dists], dim=-1)
        return torch.cat([d.rsample_from_noise(n) for d, n in zip(dists, noise)], dim=-1)

    def sample_masked(self, head_out: torch.Tensor, generator: torch.Generator, masks: Dict[str, torch.Tensor],
                      greedy: bool = False) -> torch.Tensor:
        """MineDojo-style masked sampling (JAX ``Actor.sample_masked``), with
        the draws of :meth:`sample_noise`: see :meth:`sample_masked_from_noise`."""
        noise = () if greedy else self.sample_noise(head_out.shape[:-1], generator)
        return self.sample_masked_from_noise(head_out, masks, noise, greedy)

    def sample_masked_from_noise(self, head_out: torch.Tensor, masks: Dict[str, torch.Tensor],
                                 noise: Sequence[torch.Tensor], greedy: bool = False) -> torch.Tensor:
        """Branch 0 (the compound action) is masked by ``mask_action_type``;
        branch 1 (the craft argument) by ``mask_craft_smelt`` only where
        branch 0 chose craft; branch 2 (the inventory argument) by
        ``mask_equip_place`` or ``mask_destroy`` only where branch 0 chose
        equip/place or destroy.  A mask is a float observation, nonzero where
        allowed; it is applied after the unimix (a ``-1e9`` logit), so an
        excluded action has probability zero.  Branch-free, so the step is
        captured in the player's graph."""
        dists = self.dists(head_out)  # the unimix is folded into each .logits

        def draw(i: int, allowed: torch.Tensor) -> torch.Tensor:
            d = OneHotCategorical(torch.where(allowed, dists[i].logits, torch.full_like(dists[i].logits, -1e9)))
            return d.mode() if greedy else d.sample_from_noise(noise[i])

        a0 = draw(0, masks["mask_action_type"] > 0)
        compound = torch.argmax(a0, dim=-1, keepdim=True)
        parts = [a0]
        if len(dists) > 1:  # the craft/smelt argument
            is_craft = compound == N_MOVEMENT_ACTIONS + FN_CRAFT - 1
            parts.append(draw(1, (masks["mask_craft_smelt"] > 0) | ~is_craft))
        if len(dists) > 2:  # the inventory-item argument
            is_equip_place = (compound == N_MOVEMENT_ACTIONS + FN_EQUIP - 1) | (
                compound == N_MOVEMENT_ACTIONS + FN_PLACE - 1)
            is_destroy = compound == N_MOVEMENT_ACTIONS + FN_DESTROY - 1
            allowed = torch.where(is_equip_place, masks["mask_equip_place"] > 0,
                                  (masks["mask_destroy"] > 0) | ~is_destroy)
            parts.append(draw(2, allowed))
        return torch.cat(parts, dim=-1)

    def log_prob(self, head_out: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        dists = self.dists(head_out)
        if self.is_continuous:
            return dists[0].log_prob(actions)
        lp, start = 0.0, 0
        for d, dim in zip(dists, self.actions_dim):
            lp = lp + d.log_prob(actions[..., start : start + dim])
            start += dim
        return lp

    def entropy(self, head_out: torch.Tensor) -> torch.Tensor:
        return sum(d.entropy() for d in self.dists(head_out))


class Critic(nn.Module):
    """Latent → two-hot bins."""

    def __init__(
        self, latent_size: int, dense_units: int = 512, mlp_layers: int = 2, act: str = "silu",
        layer_norm: bool = True, bins: int = 255, dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.trunk = DreamerMLP(latent_size, dense_units, mlp_layers, act=act, layer_norm=layer_norm, dtype=dtype)
        self.head = Dense(dense_units, bins)

    def forward(self, latent: torch.Tensor) -> torch.Tensor:
        return self.head(self.trunk(latent))

    def init_weights(self, g: torch.Generator) -> None:
        self.trunk.init_weights(g)
        _trunk_(self.head, g, zero=True)


def obs_shapes(cfg: Any, obs_space: Any) -> Tuple[Dict[str, Tuple[int, int, int]], Dict[str, int]]:
    """Per-key encoder input shapes: NHWC images (frame stacks merged into
    channels) and flat vector widths."""
    cnn_shapes = {}
    for k in cfg.algo.cnn_keys.encoder:
        shape = obs_space[k].shape
        if len(shape) == 4:  # frame-stacked: merged into channels
            shape = (shape[1], shape[2], shape[0] * shape[3])
        cnn_shapes[k] = tuple(int(s) for s in shape)
    mlp_shapes = {k: int(np.prod(obs_space[k].shape)) for k in cfg.algo.mlp_keys.encoder}
    return cnn_shapes, mlp_shapes


def new_actor(cfg: Any, latent: int, actions_dim: Sequence[int], is_continuous: bool,
              dtype: torch.dtype = torch.float32) -> Actor:
    """The DreamerV3 actor of ``cfg.algo.actor`` on ``latent``-wide inputs."""
    a = cfg.algo.actor
    return Actor(latent, actions_dim, is_continuous, dense_units=a.dense_units, mlp_layers=a.mlp_layers,
                 unimix=a.unimix, min_std=a.min_std, max_std=a.max_std, init_std=a.init_std,
                 action_clip=a.action_clip, dtype=dtype)


def new_critic(cfg: Any, latent: int, dtype: torch.dtype = torch.float32) -> Critic:
    """The DreamerV3 critic of ``cfg.algo.critic`` on ``latent``-wide inputs."""
    c = cfg.algo.critic
    return Critic(latent, dense_units=c.dense_units, mlp_layers=c.mlp_layers, bins=c.bins, dtype=dtype)


def place_modules(modules: Dict[str, Any], state: Optional[Dict[str, Any]], device: Any, seed: int,
                  targets: Optional[Dict[str, str]] = None) -> None:
    """Load each module of the (nested) ``modules`` dict from the same place
    in ``state`` (modules built on the meta device), or initialise them from
    ``seed`` in dict order with each target network a copy of its online one
    (``targets``: target name → online name, at any level); then put them on
    ``device`` in eval mode."""
    targets = targets or {}
    g = torch.Generator(device).manual_seed(int(seed)) if state is None else None

    def visit(tree: Dict[str, Any], saved: Optional[Dict[str, Any]]) -> None:
        for name, module in tree.items():
            if isinstance(module, dict):
                visit(module, None if saved is None else saved[name])
            elif saved is not None:
                module.load_state_dict(saved[name], strict=True, assign=True)
            elif name not in targets:
                module.init_weights(g)
        for target, online in targets.items():
            if saved is None and target in tree:
                tree[target].load_state_dict(tree[online].state_dict())
        for module in tree.values():
            if isinstance(module, nn.Module):
                module.to(device).eval()

    visit(modules, state)


def build_agent(
    fabric: Any,
    actions_dim: Sequence[int],
    is_continuous: bool,
    cfg: Any,
    obs_space: Any,
    state: Optional[Dict[str, Any]] = None,
) -> Dict[str, nn.Module]:
    """``world_model``, ``actor``, ``critic`` and ``target_critic`` on
    ``fabric.device``, in eval mode.  ``state`` holds their ``state_dict``s
    under those names; without it the weights are the Hafner initialization
    drawn from ``cfg.seed``, and the target critic copies the critic.  The
    modules compute in ``fabric.precision.compute_dtype``."""
    cnn_shapes, mlp_shapes = obs_shapes(cfg, obs_space)
    dtype = fabric.precision.compute_dtype
    wm_cfg = cfg.algo.world_model
    stoch = wm_cfg.stochastic_size * wm_cfg.discrete_size
    latent = stoch + wm_cfg.recurrent_model.recurrent_state_size
    with torch.device("meta" if state is not None else fabric.device):
        modules = {
            "world_model": WorldModel(
                cnn_keys=tuple(cfg.algo.cnn_keys.encoder),
                mlp_keys=tuple(cfg.algo.mlp_keys.encoder),
                cnn_shapes=cnn_shapes,
                mlp_shapes=mlp_shapes,
                actions_dim=tuple(actions_dim),
                cnn_mult=wm_cfg.encoder.cnn_channels_multiplier,
                dense_units=cfg.algo.dense_units,
                mlp_layers=cfg.algo.mlp_layers,
                recurrent_size=wm_cfg.recurrent_model.recurrent_state_size,
                hidden_size=wm_cfg.transition_model.hidden_size,
                repr_hidden_size=wm_cfg.representation_model.hidden_size,
                stochastic_size=wm_cfg.stochastic_size,
                discrete_size=wm_cfg.discrete_size,
                unimix=cfg.algo.unimix,
                bins=wm_cfg.reward_model.bins,
                learnable_initial_state=wm_cfg.learnable_initial_recurrent_state,
                decoupled_rssm=wm_cfg.decoupled_rssm,
                use_pallas_gru=bool(wm_cfg.recurrent_model.get("use_pallas", False)),
                fused_pallas_rssm=bool(wm_cfg.recurrent_model.get("fused_pallas", False)),
                dtype=dtype,
            ),
            "actor": new_actor(cfg, latent, actions_dim, is_continuous, dtype),
            "critic": new_critic(cfg, latent, dtype),
            "target_critic": new_critic(cfg, latent, dtype),
        }
    place_modules(modules, state, fabric.device, int(cfg.seed), {"target_critic": "critic"})
    return modules
