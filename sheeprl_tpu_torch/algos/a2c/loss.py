"""A2C losses (counterparts of ``sheeprl_tpu/algos/a2c/loss.py``)."""

from __future__ import annotations

import torch


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    return x


def policy_loss(logprobs: torch.Tensor, advantages: torch.Tensor, reduction: str = "sum") -> torch.Tensor:
    """Vanilla policy gradient ``-E[log π(a|s) · Â]``, no gradient through Â."""
    return _reduce(-logprobs * advantages.detach(), reduction)


def value_loss(values: torch.Tensor, returns: torch.Tensor, reduction: str = "sum") -> torch.Tensor:
    """Plain squared error under ``reduction`` (no 0.5), as PPO's unclipped branch."""
    return _reduce((values - returns) ** 2, reduction)
