"""SAC losses (counterparts of ``sheeprl_tpu/algos/sac/loss.py``)."""

from __future__ import annotations

import torch


def critic_loss(qs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The sum over the N critics of each one's mean squared error (no
    0.5); ``qs`` (N, B), ``target`` (B,)."""
    return ((qs - target[None, :]) ** 2).mean(dim=1).sum()


def actor_loss(alpha: torch.Tensor, log_prob: torch.Tensor, min_q: torch.Tensor) -> torch.Tensor:
    return (alpha * log_prob - min_q).mean()


def alpha_loss(log_alpha: torch.Tensor, log_prob: torch.Tensor, target_entropy: float) -> torch.Tensor:
    """The temperature objective; its gradient reaches ``log_alpha`` only
    (``log_prob`` is detached)."""
    return -(log_alpha * (log_prob + target_entropy).detach()).mean()
