"""DreamerV2 world-model loss (counterpart of ``sheeprl_tpu/algos/dreamer_v2/loss.py``):
α-balanced categorical KL with free nats on the averages, and unit-variance
Gaussian reconstruction NLLs."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from sheeprl_tpu_torch.utils.distribution import OneHotCategorical, kl_categorical


def reconstruction_loss(
    obs_nll: torch.Tensor,
    reward_nll: torch.Tensor,
    continue_nll: Optional[torch.Tensor],
    posteriors_logits: torch.Tensor,
    priors_logits: torch.Tensor,
    kl_balancing_alpha: float = 0.8,
    kl_free_nats: float = 0.0,
    kl_regularizer: float = 1.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``obs_nll``, ``reward_nll`` and ``continue_nll`` are per-step negative
    log-likelihoods (L, B) (``continue_nll`` already scaled, or None without
    a continue head); the logits are (L, B, stochastic, discrete).  Each side
    of the balanced KL is clipped at the free nats after averaging."""
    if continue_nll is None:
        continue_nll = torch.zeros_like(reward_nll)
    post = OneHotCategorical(posteriors_logits)
    post_sg = OneHotCategorical(posteriors_logits.detach())
    prior = OneHotCategorical(priors_logits)
    prior_sg = OneHotCategorical(priors_logits.detach())
    lhs = kl_categorical(post_sg, prior).sum(-1)
    rhs = kl_categorical(post, prior_sg).sum(-1)
    loss_lhs = torch.clamp(lhs.mean(), min=kl_free_nats)
    loss_rhs = torch.clamp(rhs.mean(), min=kl_free_nats)
    kl_loss = kl_balancing_alpha * loss_lhs + (1 - kl_balancing_alpha) * loss_rhs
    total = kl_regularizer * kl_loss + (obs_nll + reward_nll + continue_nll).mean()
    aux = {
        "kl": lhs.mean(),
        "kl_loss": kl_loss,
        "observation_loss": obs_nll.mean(),
        "reward_loss": reward_nll.mean(),
        "continue_loss": continue_nll.mean(),
    }
    return total, aux
