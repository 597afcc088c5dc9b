"""PPO losses (counterparts of ``sheeprl_tpu/algos/ppo/loss.py``)."""

from __future__ import annotations

import torch


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    if reduction == "none":
        return x
    raise ValueError(f"Unknown reduction '{reduction}'")


def policy_loss(new_logprobs: torch.Tensor, old_logprobs: torch.Tensor, advantages: torch.Tensor,
                clip_coef: float, reduction: str = "mean") -> torch.Tensor:
    ratio = torch.exp(new_logprobs - old_logprobs)
    surr1 = advantages * ratio
    surr2 = advantages * torch.clamp(ratio, 1.0 - clip_coef, 1.0 + clip_coef)
    return _reduce(-torch.minimum(surr1, surr2), reduction)


def value_loss(new_values: torch.Tensor, old_values: torch.Tensor, returns: torch.Tensor, clip_coef: float,
               clip_vloss: bool, reduction: str = "mean") -> torch.Tensor:
    """Without ``clip_vloss`` a plain squared error under ``reduction``;
    with it ``0.5 · mean(max(unclipped, clipped))`` whatever ``reduction``
    says, the scale the JAX package keeps from the reference."""
    if not clip_vloss:
        return _reduce((new_values - returns) ** 2, reduction)
    v_clipped = old_values + torch.clamp(new_values - old_values, -clip_coef, clip_coef)
    losses = torch.maximum((new_values - returns) ** 2, (v_clipped - returns) ** 2)
    return 0.5 * losses.mean()


def entropy_loss(entropy: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    return _reduce(-entropy, reduction)
