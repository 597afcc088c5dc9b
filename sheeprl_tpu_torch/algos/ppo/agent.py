"""PPO agent (counterpart of ``sheeprl_tpu/algos/ppo/agent.py``).

A :class:`~sheeprl_tpu_torch.models.models.MultiEncoder` feature extractor
(CNN channels 32/64/64 on the images, an MLP on the vectors) feeding
separate actor and critic MLP heads.  Continuous actions parameterise a
Gaussian (mean and a log-std clipped to [-10, 2]) under
``distribution.type``; discrete and multi-discrete actions one categorical
per branch, stored as float branch indices ``(B, n_branches)``.

Sampling takes its noise as a list of tensors (one per discrete branch, or
one for the continuous action) or draws it from a ``torch.Generator``
(:func:`action_noise`), so a test can hand the port the draws JAX's keys make.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from sheeprl_tpu_torch.models.models import MLP, MultiEncoder
from sheeprl_tpu_torch.utils.distribution import Categorical, MultiCategorical, Normal, TanhNormal, TruncatedNormal
from sheeprl_tpu_torch.utils.utils import safeatanh

Noise = Union[torch.Generator, Sequence[torch.Tensor]]


class PPOAgent(nn.Module):
    """``forward(obs) -> (actor_out, value)``; ``obs`` holds NHWC images in
    [0, 1] (frame stacks merged into channels) and flat vectors.  The
    modules compute in ``dtype``; both outputs come back fp32, as in JAX."""

    def __init__(self, actions_dim: Sequence[int], is_continuous: bool, cnn_keys: Sequence[str],
                 mlp_keys: Sequence[str], cnn_shapes: Dict[str, Tuple[int, int, int]], mlp_shapes: Dict[str, int],
                 encoder_cfg: Dict[str, Any], actor_cfg: Dict[str, Any], critic_cfg: Dict[str, Any],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        enc = encoder_cfg
        self.feature_extractor = MultiEncoder(
            cnn_keys, mlp_keys, cnn_shapes, mlp_shapes,
            cnn_channels=(32, 64, 64),
            cnn_features_dim=enc.get("cnn_features_dim"),
            mlp_sizes=(enc.get("dense_units", 64),) * enc.get("mlp_layers", 2),
            mlp_layer_norm=enc.get("layer_norm", False),
            mlp_features_dim=enc.get("mlp_features_dim"),
            activation=enc.get("dense_act", "tanh"),
            dtype=dtype,
        )
        d = self.feature_extractor.out_features
        self.actor = _head(d, actor_cfg, sum(actions_dim) * (2 if is_continuous else 1), dtype)
        self.critic = _head(d, critic_cfg, 1, dtype)

    def forward(self, obs: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        features = self.feature_extractor(obs)
        return self.actor(features).float(), self.critic(features).float()

    def init_weights(self, generator: torch.Generator) -> None:
        for module in (self.feature_extractor, self.actor, self.critic):
            module.init_weights(generator)


def _head(input_dim: int, cfg: Dict[str, Any], output_dim: int, dtype: torch.dtype = torch.float32) -> MLP:
    return MLP(input_dim, (cfg.get("dense_units", 64),) * cfg.get("mlp_layers", 2), output_dim,
               activation=cfg.get("dense_act", "tanh"), layer_norm=cfg.get("layer_norm", False), dtype=dtype)


def split_actor_out(actor_out: torch.Tensor, actions_dim: Sequence[int], is_continuous: bool):
    """The actor head output as ``(mean, log_std)`` with the log-std clipped
    to [-10, 2], or as one logits tensor per discrete branch."""
    if is_continuous:
        mean, log_std = torch.chunk(actor_out, 2, dim=-1)
        return mean, torch.clamp(log_std, -10.0, 2.0)
    return list(torch.split(actor_out, list(actions_dim), dim=-1))


def continuous_dist(mean: torch.Tensor, log_std: torch.Tensor, dist_type: str = "auto"):
    """``distribution.type``: ``auto``/``normal`` an independent Gaussian,
    ``trunc_normal`` a Gaussian around ``tanh(mean)`` truncated to [-1, 1];
    ``tanh_normal`` is handled by the callers."""
    std = torch.exp(log_std)
    if dist_type in ("auto", "normal"):
        return Normal(mean, std, event_dims=1)
    if dist_type == "tanh_normal":
        raise ValueError("tanh_normal is handled in sample_actions/evaluate_actions, never through continuous_dist")
    if dist_type == "trunc_normal":
        return TruncatedNormal(torch.tanh(mean), std, low=-1.0, high=1.0, event_dims=1)
    raise ValueError(f"Unknown distribution type '{dist_type}'")


def action_noise(actor_out: torch.Tensor, actions_dim: Sequence[int], is_continuous: bool, dist_type: str,
                 generator: torch.Generator) -> List[torch.Tensor]:
    """The draws :func:`sample_actions` consumes for this actor output."""
    lead, dev = actor_out.shape[:-1], actor_out.device
    if is_continuous:
        sampler = TruncatedNormal if dist_type == "trunc_normal" else Normal
        return [sampler.sample_noise((*lead, actions_dim[0]), generator, dev)]
    return [Categorical.sample_noise((*lead, d), generator, dev) for d in actions_dim]


def sample_actions(actor_out: torch.Tensor, actions_dim: Sequence[int], is_continuous: bool, noise: Noise = None,
                   greedy: bool = False, dist_type: str = "auto") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(actions, log_prob, entropy)``: float branch indices ``(B,
    n_branches)`` or continuous values ``(B, act_dim)``.  ``noise`` is a
    generator or the draws of :func:`action_noise`; greedy draws none."""
    if not greedy and isinstance(noise, torch.Generator):
        noise = action_noise(actor_out, actions_dim, is_continuous, dist_type, noise)
    if is_continuous:
        mean, log_std = split_actor_out(actor_out, actions_dim, True)
        if dist_type == "tanh_normal":
            d = TanhNormal(mean, torch.exp(log_std), event_dims=1)
            if greedy:
                action, lp = d.mode(), torch.zeros(mean.shape[:-1], device=mean.device)
            else:
                action, lp = d.sample_and_log_prob_from_noise(noise[0])
            # the base Gaussian's entropy (the squashed one has no closed form)
            return action, lp, Normal(mean, torch.exp(log_std), event_dims=1).entropy()
        dist = continuous_dist(mean, log_std, dist_type)
        action = dist.mode() if greedy else dist.sample_from_noise(noise[0])
        return action, dist.log_prob(action), dist.entropy()
    d = MultiCategorical(split_actor_out(actor_out, actions_dim, False))
    actions = d.mode() if greedy else d.sample_from_noise(noise)
    return actions.to(torch.float32), d.log_prob(actions), d.entropy()


def evaluate_actions(actor_out: torch.Tensor, actions: torch.Tensor, actions_dim: Sequence[int],
                     is_continuous: bool, dist_type: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Log-prob and entropy of stored actions under ``actor_out``."""
    if is_continuous:
        mean, log_std = split_actor_out(actor_out, actions_dim, True)
        if dist_type == "tanh_normal":
            base = Normal(mean, torch.exp(log_std), event_dims=1)
            lp = base.log_prob(safeatanh(actions)) - torch.sum(torch.log(1.0 - actions**2 + 1e-6), dim=-1)
            return lp, base.entropy()
        dist = continuous_dist(mean, log_std, dist_type)
        return dist.log_prob(actions), dist.entropy()
    d = MultiCategorical(split_actor_out(actor_out, actions_dim, False))
    return d.log_prob(actions), d.entropy()


def encoder_shapes(cfg: Any, obs_space: Any) -> Tuple[Dict[str, Tuple[int, int, int]], Dict[str, int]]:
    """NHWC image shapes (frame stacks merged into channels) and flat vector
    widths of the configured encoder keys."""
    cnn_shapes = {}
    for k in cfg.algo.cnn_keys.encoder:
        shape = obs_space[k].shape
        if len(shape) == 4:  # (S, H, W, C) frame stack
            shape = (shape[1], shape[2], shape[0] * shape[3])
        cnn_shapes[k] = tuple(int(s) for s in shape)
    mlp_shapes = {k: int(np.prod(obs_space[k].shape)) for k in cfg.algo.mlp_keys.encoder}
    return cnn_shapes, mlp_shapes


def place_agent(agent: nn.Module, state: Optional[Dict[str, torch.Tensor]], device: Any, seed: int) -> nn.Module:
    """``agent`` (built on the meta device when ``state`` is given) loaded
    from ``state``, or initialised from ``seed``, on ``device``."""
    if state is not None:
        agent.load_state_dict(state, strict=True, assign=True)
    else:
        agent.init_weights(torch.Generator(device).manual_seed(int(seed)))
    return agent.to(device)


def build_agent(fabric: Any, actions_dim: Sequence[int], is_continuous: bool, cfg: Any, obs_space: Any,
                agent_state: Optional[Dict[str, torch.Tensor]] = None) -> PPOAgent:
    """The agent on ``fabric.device``, from ``agent_state`` (a ``state_dict``)
    or initialised like flax.  The JAX package initialises this agent from
    ``PRNGKey(0)`` whatever the seed, so the port seeds its generator with 0."""
    cnn_shapes, mlp_shapes = encoder_shapes(cfg, obs_space)
    with torch.device("meta" if agent_state is not None else fabric.device):
        agent = PPOAgent(tuple(actions_dim), is_continuous, tuple(cfg.algo.cnn_keys.encoder),
                         tuple(cfg.algo.mlp_keys.encoder), cnn_shapes, mlp_shapes, dict(cfg.algo.encoder),
                         dict(cfg.algo.actor), dict(cfg.algo.critic), fabric.precision.compute_dtype)
    return place_agent(agent, agent_state, fabric.device, 0)
