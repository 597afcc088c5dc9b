"""DreamerV1 agent (counterpart of ``sheeprl_tpu/algos/dreamer_v1/agent.py``).

:class:`GaussianWorldModel`: an RSSM with continuous Gaussian latents (mean,
softplus std + ``min_std``) on the DreamerV3 recurrent model, with the
encoder, decoder and heads of the DreamerV3 family configured without
LayerNorm stages.  It has the method surface of the categorical
``WorldModel`` (``encode``, ``dynamic_noise``, ``imagination_noise``,
``decode``, the heads, ``latent_noise``), so the family's loop and player
drive it unchanged; ``dynamic_noise`` returns the posterior and prior
(mean ‖ std) where V3 returns logits.  It takes no kernel flag, as in JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from sheeprl_tpu_torch.algos.dreamer_v3.agent import (
    Actor,
    Critic,
    Decoder,
    DreamerMLP,
    Encoder,
    RecurrentModel,
    obs_shapes,
    place_modules,
)


class GaussianWorldModel(nn.Module):
    def __init__(
        self,
        cnn_keys: Sequence[str],
        mlp_keys: Sequence[str],
        cnn_shapes: Dict[str, Tuple[int, int, int]],
        mlp_shapes: Dict[str, int],
        actions_dim: Sequence[int],
        cnn_mult: int = 32,
        dense_units: int = 400,
        mlp_layers: int = 4,
        recurrent_size: int = 200,
        hidden_size: int = 200,
        stochastic_size: int = 30,
        min_std: float = 0.1,
        act: str = "elu",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.stochastic_size = self.stoch_flat = stochastic_size
        self.recurrent_size = recurrent_size
        self.min_std = min_std
        latent = stochastic_size + recurrent_size
        self.encoder = Encoder(cnn_keys, mlp_keys, cnn_shapes, mlp_shapes, cnn_mult=cnn_mult, mlp_units=dense_units,
                               mlp_layers=mlp_layers, act=act, layer_norm=False, symlog_inputs=False, dtype=dtype)
        self.recurrent_model = RecurrentModel(stochastic_size + int(sum(actions_dim)), recurrent_size, dense_units,
                                              dtype=dtype)
        self.representation_model = DreamerMLP(recurrent_size + self.encoder.out_features, hidden_size, 1,
                                               output_dim=2 * stochastic_size, act=act, layer_norm=False, dtype=dtype)
        self.transition_model = DreamerMLP(recurrent_size, hidden_size, 1, output_dim=2 * stochastic_size, act=act,
                                           layer_norm=False, dtype=dtype)
        self.observation_model = Decoder(latent, cnn_keys, mlp_keys, cnn_shapes, mlp_shapes, cnn_mult=cnn_mult,
                                         mlp_units=dense_units, mlp_layers=mlp_layers, act=act, layer_norm=False,
                                         dtype=dtype)
        self.reward_model = DreamerMLP(latent, dense_units, mlp_layers, output_dim=1, act=act, layer_norm=False,
                                       dtype=dtype)
        self.continue_model = DreamerMLP(latent, dense_units, mlp_layers, output_dim=1, act=act, layer_norm=False,
                                         dtype=dtype)

    def init_weights(self, g: torch.Generator) -> None:
        for name in ("encoder", "recurrent_model", "representation_model", "transition_model",
                     "observation_model", "reward_model", "continue_model"):
            getattr(self, name).init_weights(g)

    def _moments(self, raw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, std_raw = torch.chunk(raw, 2, dim=-1)
        return mean, F.softplus(std_raw) + self.min_std

    def encode(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.encoder(obs)

    def latent_noise(self, lead: Sequence[int], generator: torch.Generator) -> torch.Tensor:
        """The standard normal noise of ``lead``-shaped latent samples: (*lead, stoch)."""
        return torch.randn((*lead, self.stochastic_size), generator=generator, device=generator.device)

    def posterior_noise(self, batch: int, generator: torch.Generator) -> torch.Tensor:
        return self.latent_noise((batch,), generator)

    def dynamic_noise(self, prev_h, prev_z, prev_action, embed, is_first, noise: torch.Tensor):
        """One posterior step with pre-drawn normal noise (B, stoch): zero
        (h, z, a) at episode starts, advance the recurrent model, sample the
        posterior.  Returns (h, z, posterior mean‖std, prior mean‖std)."""
        mask = 1.0 - is_first
        h = self.recurrent_model(prev_h * mask, torch.cat([prev_z * mask, prev_action * mask], dim=-1)).float()
        prior_mean, prior_std = self._moments(self.transition_model(h))
        post_mean, post_std = self._moments(self.representation_model(torch.cat([h, embed], dim=-1)))
        z = post_mean + post_std * noise
        return h, z, torch.cat([post_mean, post_std], -1), torch.cat([prior_mean, prior_std], -1)

    def imagination_noise(self, prev_h, prev_z, action, noise: torch.Tensor):
        h = self.recurrent_model(prev_h, torch.cat([prev_z, action], dim=-1)).float()
        prior_mean, prior_std = self._moments(self.transition_model(h))
        return h, prior_mean + prior_std * noise

    def decode(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.observation_model(latent)

    def reward_logits(self, latent: torch.Tensor) -> torch.Tensor:
        return self.reward_model(latent)

    def continue_logits(self, latent: torch.Tensor) -> torch.Tensor:
        return self.continue_model(latent)


def latent_size(cfg: Any) -> int:
    wm_cfg = cfg.algo.world_model
    return int(wm_cfg.stochastic_size) + int(wm_cfg.recurrent_model.recurrent_state_size)


def new_actor(cfg: Any, actions_dim: Sequence[int], is_continuous: bool, dtype: torch.dtype = torch.float32) -> Actor:
    a = cfg.algo.actor
    return Actor(latent_size(cfg), actions_dim, is_continuous, dense_units=a.dense_units, mlp_layers=a.mlp_layers,
                 act=cfg.algo.dense_act, layer_norm=False, unimix=0.0, min_std=a.min_std, init_std=a.init_std,
                 action_clip=1.0, dtype=dtype)


def new_critic(cfg: Any, dtype: torch.dtype = torch.float32) -> Critic:
    c = cfg.algo.critic
    return Critic(latent_size(cfg), dense_units=c.dense_units, mlp_layers=c.mlp_layers, act=cfg.algo.dense_act,
                  layer_norm=False, bins=1, dtype=dtype)


def build_agent(fabric: Any, actions_dim: Sequence[int], is_continuous: bool, cfg: Any, obs_space: Any,
                state: Optional[Dict[str, Any]] = None) -> Dict[str, nn.Module]:
    """World model, actor and value network in eval mode on
    ``fabric.device``: from ``state``, or initialised from ``cfg.seed``.  The
    modules compute in ``fabric.precision.compute_dtype``."""
    cnn_shapes, mlp_shapes = obs_shapes(cfg, obs_space)
    wm_cfg = cfg.algo.world_model
    dtype = fabric.precision.compute_dtype
    with torch.device("meta" if state is not None else fabric.device):
        modules = {
            "world_model": GaussianWorldModel(
                tuple(cfg.algo.cnn_keys.encoder), tuple(cfg.algo.mlp_keys.encoder), cnn_shapes, mlp_shapes,
                tuple(actions_dim), cnn_mult=wm_cfg.encoder.cnn_channels_multiplier, dense_units=cfg.algo.dense_units,
                mlp_layers=cfg.algo.mlp_layers, recurrent_size=wm_cfg.recurrent_model.recurrent_state_size,
                hidden_size=wm_cfg.transition_model.hidden_size, stochastic_size=wm_cfg.stochastic_size,
                min_std=float(wm_cfg.min_std), act=cfg.algo.dense_act, dtype=dtype,
            ),
            "actor": new_actor(cfg, actions_dim, is_continuous, dtype),
            "critic": new_critic(cfg, dtype),
        }
    place_modules(modules, state, fabric.device, int(cfg.seed))
    return modules
