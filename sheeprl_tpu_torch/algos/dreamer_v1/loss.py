"""DreamerV1 world-model loss (counterpart of ``sheeprl_tpu/algos/dreamer_v1/loss.py``):
the plain KL of the Gaussian posterior to the prior with free nats, and
unit-variance Gaussian reconstruction NLLs.  As in the JAX package, the
continue term is a negative log-likelihood (the original adds a positive
one; it ships ``use_continues: False``, so the default path is the same)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from sheeprl_tpu_torch.utils.distribution import Normal, kl_normal


def reconstruction_loss(
    obs_nll: torch.Tensor,
    reward_nll: torch.Tensor,
    continue_nll: Optional[torch.Tensor],
    post_mean: torch.Tensor,
    post_std: torch.Tensor,
    prior_mean: torch.Tensor,
    prior_std: torch.Tensor,
    kl_free_nats: float = 3.0,
    kl_regularizer: float = 1.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``obs_nll``, ``reward_nll`` and ``continue_nll`` are per-step negative
    log-likelihoods (L, B) (``continue_nll`` already scaled, or None without
    a continue head); posterior and prior are diagonal Gaussians over the
    stochastic state."""
    if continue_nll is None:
        continue_nll = torch.zeros_like(reward_nll)
    kl = kl_normal(Normal(post_mean, post_std, event_dims=1), Normal(prior_mean, prior_std, event_dims=1))
    state_loss = torch.clamp(kl.mean(), min=kl_free_nats)
    total = kl_regularizer * state_loss + (obs_nll + reward_nll + continue_nll).mean()
    aux = {
        "kl": kl.mean(),
        "kl_loss": state_loss,
        "observation_loss": obs_nll.mean(),
        "reward_loss": reward_nll.mean(),
        "continue_loss": continue_nll.mean(),
    }
    return total, aux
