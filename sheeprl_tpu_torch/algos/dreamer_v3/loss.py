"""DreamerV3 world-model loss (counterpart of ``sheeprl_tpu/algos/dreamer_v3/loss.py``)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from sheeprl_tpu_torch.utils.distribution import OneHotCategorical, kl_categorical


def world_model_loss(
    obs_log_probs: Dict[str, torch.Tensor],
    reward_log_prob: torch.Tensor,
    continue_log_prob: torch.Tensor,
    posterior_logits: torch.Tensor,
    prior_logits: torch.Tensor,
    kl_dynamic: float = 0.5,
    kl_representation: float = 0.1,
    kl_free_nats: float = 1.0,
    kl_regularizer: float = 1.0,
    continue_scale_factor: float = 1.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Eq. 5 of the DreamerV3 paper: reconstruction + reward + continue NLL
    plus the free-nats-clipped balanced KL.

    The log-probs are (T, B); the logits (T, B, stoch, discrete).  The KL is
    summed over the stochastic axis."""
    observation_loss = -sum(obs_log_probs.values())
    reward_loss = -reward_log_prob
    continue_loss = -continue_scale_factor * continue_log_prob

    post = OneHotCategorical(posterior_logits)
    post_sg = OneHotCategorical(posterior_logits.detach())
    prior = OneHotCategorical(prior_logits)
    prior_sg = OneHotCategorical(prior_logits.detach())

    kl = kl_categorical(post_sg, prior).sum(-1)
    dyn_loss = kl_dynamic * torch.clamp(kl, min=kl_free_nats)
    repr_loss = kl_representation * torch.clamp(kl_categorical(post, prior_sg).sum(-1), min=kl_free_nats)
    kl_loss = dyn_loss + repr_loss

    total = torch.mean(kl_regularizer * kl_loss + observation_loss + reward_loss + continue_loss)
    aux = {
        "kl": kl.mean(),
        "kl_loss": kl_loss.mean(),
        "observation_loss": observation_loss.mean(),
        "reward_loss": reward_loss.mean(),
        "continue_loss": continue_loss.mean(),
    }
    return total, aux
