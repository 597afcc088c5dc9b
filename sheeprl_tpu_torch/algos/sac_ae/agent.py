"""SAC-AE agent (counterpart of ``sheeprl_tpu/algos/sac_ae/agent.py``).

:class:`AEEncoder` turns observations into a feature vector that the actor
and the critics share: a CNN 16/32/64 (kernel 4, stride 2, XLA's SAME
padding) over the images concatenated on channels, an MLP over the
vectors, then a ``proj`` Dense, a ``ln`` LayerNorm and ``tanh``.  That
LayerNorm is flax's own ``nn.LayerNorm``, whose eps is 1e-6 (not the
repo's wrapper's 1e-5).  A :class:`~sheeprl_tpu_torch.models.models.MultiDecoder`
reconstructs the observations from the features.  :class:`SACAEAgent`
carries the encoder, the decoder, SAC's actor and critic ensemble at
``algo.hidden_size``, the EMA targets of the encoder and the critic, and
``log_alpha``.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from sheeprl_tpu_torch.algos.ppo.agent import encoder_shapes
from sheeprl_tpu_torch.algos.sac.agent import SACActor, SACAgent, SACCriticEnsemble, place_agent
from sheeprl_tpu_torch.models.models import CNN, MLP, Dense, LayerNorm, MultiDecoder, lecun_init_


class AEEncoder(nn.Module):
    """The CNN and the MLP compute in ``dtype``; ``proj``, ``ln`` and the
    features stay fp32, as in JAX."""

    def __init__(self, cnn_keys: Sequence[str], mlp_keys: Sequence[str], cnn_shapes: Dict[str, Tuple[int, int, int]],
                 mlp_shapes: Dict[str, int], features_dim: int = 64, cnn_mult: int = 16, dense_units: int = 64,
                 mlp_layers: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cnn_keys, self.mlp_keys = tuple(cnn_keys), tuple(mlp_keys)
        d = 0
        if self.cnn_keys:
            h, w, _ = cnn_shapes[self.cnn_keys[0]]
            c = sum(cnn_shapes[k][-1] for k in self.cnn_keys)
            self.cnn = CNN((h, w, c), (cnn_mult, cnn_mult * 2, cnn_mult * 4), kernel_size=4, stride=2,
                           activation="relu", dtype=dtype)
            d += self.cnn.out_features
        if self.mlp_keys:
            self.mlp = MLP(sum(mlp_shapes[k] for k in self.mlp_keys), (dense_units,) * mlp_layers, activation="relu",
                           dtype=dtype)
            d += self.mlp.out_features
        self.proj = Dense(d, features_dim)
        self.ln = LayerNorm(features_dim, eps=1e-6)
        self.out_features = features_dim

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        feats = []
        if self.cnn_keys:
            feats.append(self.cnn(torch.cat([obs[k] for k in self.cnn_keys], dim=-1)))
        if self.mlp_keys:
            feats.append(self.mlp(torch.cat([obs[k] for k in self.mlp_keys], dim=-1)))
        return torch.tanh(self.ln(self.proj(torch.cat(feats, dim=-1))))

    def init_weights(self, generator: torch.Generator) -> None:
        if self.cnn_keys:
            self.cnn.init_weights(generator)
        if self.mlp_keys:
            self.mlp.init_weights(generator)
        lecun_init_(self.proj, generator)
        with torch.no_grad():
            self.ln.weight.fill_(1.0)
            self.ln.bias.zero_()


class SACAEAgent(SACAgent):
    """SAC's ``actor``, ``critic``, ``target_critic`` and ``log_alpha``, with
    the ``encoder``, its ``target_encoder`` copy and the ``decoder``."""

    def __init__(self, encoder: AEEncoder, decoder: MultiDecoder, actor: nn.Module, critic: nn.Module, alpha: float):
        super().__init__(actor, critic, alpha)
        self.encoder = encoder
        self.decoder = decoder
        self.target_encoder = copy.deepcopy(encoder)

    def init_weights(self, generator: torch.Generator) -> None:
        self.encoder.init_weights(generator)
        self.decoder.init_weights(generator)
        super().init_weights(generator)
        self.target_encoder.load_state_dict(self.encoder.state_dict())


def build_agent(fabric: Any, act_dim: int, cfg: Any, obs_space: Any,
                state: Optional[Dict[str, torch.Tensor]] = None) -> SACAEAgent:
    """The agent on ``fabric.device``, from ``state`` or initialised like flax
    from ``cfg.seed``; frame stacks of 4-d image spaces merge into channels."""
    a = cfg.algo
    dtype = fabric.precision.compute_dtype
    cnn_keys, mlp_keys = tuple(a.cnn_keys.encoder), tuple(a.mlp_keys.encoder)
    cnn_shapes, mlp_shapes = encoder_shapes(cfg, obs_space)
    features = int(a.encoder.features_dim)
    dec_mult = int(a.decoder.cnn_channels_multiplier)
    with torch.device("meta" if state is not None else fabric.device):
        encoder = AEEncoder(cnn_keys, mlp_keys, cnn_shapes, mlp_shapes, features, int(a.encoder.cnn_channels_multiplier),
                            int(a.encoder.dense_units), int(a.encoder.mlp_layers), dtype)
        decoder = MultiDecoder(features, cnn_keys, mlp_keys, cnn_shapes, mlp_shapes,
                               cnn_channels=(dec_mult * 2, dec_mult), cnn_stem_channels=dec_mult * 4,
                               mlp_sizes=(int(a.decoder.dense_units),) * int(a.decoder.mlp_layers), activation="relu",
                               dtype=dtype)
        agent = SACAEAgent(encoder, decoder, SACActor(features, act_dim, int(a.hidden_size), dtype=dtype),
                           SACCriticEnsemble(features + act_dim, int(a.critic.n), int(a.hidden_size), dtype=dtype),
                           float(a.alpha.alpha))
    return place_agent(agent, state, fabric.device, int(cfg.seed))
