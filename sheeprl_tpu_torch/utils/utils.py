"""Small numeric and host helpers (counterparts of ``sheeprl_tpu/utils/utils.py``).

The tensor functions take any device.  :class:`Ratio`, :class:`TrainWindow`
and :func:`save_configs` are host code, copied from the JAX package.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import yaml


def symlog(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def two_hot_buckets(x: torch.Tensor, buckets: torch.Tensor) -> torch.Tensor:
    """Two-hot weights of ``x`` (..., 1), already in bucket space and inside
    ``[buckets[0], buckets[-1]]``, over ``buckets`` (n,): (..., n).

    ``below = sum(buckets <= x) - 1`` as in the JAX package (not
    ``torch.bucketize``, which breaks ties on the other side).  At the top
    bucket ``below == above``: both distances are forced to 1, so the two
    halves land on the one bucket."""
    n = buckets.shape[0]
    below = torch.sum((buckets <= x).to(torch.int64), dim=-1) - 1
    below = below.clamp(0, n - 1)
    above = (below + 1).clamp(0, n - 1)
    x0 = x.squeeze(-1)
    equal = below == above
    one = torch.ones_like(x0)
    d_below = torch.where(equal, one, torch.abs(buckets[below] - x0))
    d_above = torch.where(equal, one, torch.abs(buckets[above] - x0))
    total = d_below + d_above
    w_below = d_above / total
    w_above = d_below / total
    return (
        torch.nn.functional.one_hot(below, n).to(x.dtype) * w_below[..., None]
        + torch.nn.functional.one_hot(above, n).to(x.dtype) * w_above[..., None]
    )


def two_hot_encoder(x: torch.Tensor, support_range: int = 300, num_buckets: Optional[int] = None) -> torch.Tensor:
    """Symlog two-hot encoding onto a symmetric integer support:
    ``x`` (..., 1) → (..., num_buckets)."""
    if num_buckets is None:
        num_buckets = int(2 * support_range + 1)
    x = symlog(x).clamp(-support_range, support_range)
    buckets = torch.linspace(-support_range, support_range, num_buckets, dtype=x.dtype, device=x.device)
    return two_hot_buckets(x, buckets)


def two_hot_decoder(probs: torch.Tensor, support_range: int = 300) -> torch.Tensor:
    """Inverse of :func:`two_hot_encoder`: (..., num_buckets) → (..., 1)."""
    buckets = torch.linspace(-support_range, support_range, probs.shape[-1], dtype=probs.dtype, device=probs.device)
    return symexp(torch.sum(probs * buckets, dim=-1, keepdim=True))


def gae(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    next_value: torch.Tensor,
    gamma: float,
    lmbda: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized advantage estimation over a ``(T, B, ...)`` rollout, a
    reversed loop over T.  ``dones[t]`` flags that the episode ended at step
    t; ``next_value`` bootstraps the step after the last.  Returns
    ``(returns, advantages)`` shaped like ``rewards``."""
    not_done = 1.0 - dones.to(values.dtype)
    lastgaelam, next_val = torch.zeros_like(next_value), next_value
    advantages = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * next_val * not_done[t] - values[t]
        lastgaelam = delta + gamma * lmbda * not_done[t] * lastgaelam
        advantages.append(lastgaelam)
        next_val = values[t]
    advantages = torch.stack(advantages[::-1], dim=0)
    return advantages + values, advantages


def polynomial_decay(current_step: int, *, initial: float = 1.0, final: float = 0.0, max_decay_steps: int = 100,
                     power: float = 1.0) -> float:
    """Host-side polynomial schedule from ``initial`` to ``final`` over
    ``max_decay_steps``, ``final`` after it."""
    if current_step > max_decay_steps or initial == final:
        return final
    frac = (1 - current_step / max_decay_steps) ** power
    return (initial - final) * frac + final


def safeatanh(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return torch.atanh(torch.clamp(x, -1.0 + eps, 1.0 - eps))


def normalize_tensor(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    # unbiased std, as the JAX package's ddof=1
    return (x - x.mean()) / (x.std() + eps)


def merge_framestack(x: Any) -> Any:
    """``(..., S, H, W, C)`` framestacked pixels -> ``(..., H, W, S*C)``, a
    numpy array or a tensor (on its device)."""
    s = x.shape
    x = x.movedim(-4, -2) if isinstance(x, torch.Tensor) else np.moveaxis(x, -4, -2)  # (..., H, W, S, C)
    return x.reshape(*s[:-4], s[-3], s[-2], s[-4] * s[-1])


class TrainWindow:
    """Accrues the gradient steps :class:`Ratio` owes over ``window_iters``
    env iterations (``algo.train_window_iters``) and releases them as one
    train phase; 1 trains every iteration.  ``pending`` (steps owed and not
    yet run) is saved in the checkpoint."""

    def __init__(self, window_iters: int, pending: int = 0):
        self.window_iters = max(int(window_iters), 1)
        self.pending = int(pending)

    def push(self, granted: int, update: int, learning_starts: int, total_iters: int) -> int:
        """Add this iteration's granted steps; return how many to run now (0
        while the window fills).  The last iteration always flushes."""
        self.pending += int(granted)
        window_full = (update - learning_starts) % self.window_iters == self.window_iters - 1
        if self.pending > 0 and (window_full or update == total_iters):
            out, self.pending = self.pending, 0
            return out
        return 0


class Ratio:
    """Keeps gradient-steps : env-steps at a configured ratio (Hafner's law:
    the first call converts ``pretrain_steps``, clamped to the current step
    count, when set, else the current steps; later calls convert the delta
    and carry the fractional remainder in step units)."""

    def __init__(self, ratio: float, pretrain_steps: int = 0):
        if pretrain_steps < 0:
            raise ValueError(f"pretrain_steps must be non-negative, got {pretrain_steps}")
        if ratio < 0:
            raise ValueError(f"ratio must be non-negative, got {ratio}")
        self._ratio = float(ratio)
        self._pretrain_steps = int(pretrain_steps)
        self._prev: Optional[float] = None

    def __call__(self, in_steps: int) -> int:
        if self._ratio == 0:
            return 0
        if self._prev is None:
            self._prev = in_steps
            if self._pretrain_steps > 0:
                if in_steps < self._pretrain_steps:
                    warnings.warn(
                        "pretrain_steps exceeds the current step count; clamping "
                        "to the current steps (reference behavior)", UserWarning
                    )
                    self._pretrain_steps = in_steps
                return int(self._pretrain_steps * self._ratio)
            return int(in_steps * self._ratio)
        repeats = int((in_steps - self._prev) * self._ratio)
        self._prev += repeats / self._ratio
        return repeats

    def state_dict(self) -> Dict[str, Any]:
        return {"ratio": self._ratio, "pretrain_steps": self._pretrain_steps, "prev": self._prev}

    def load_state_dict(self, state: Dict[str, Any]) -> "Ratio":
        self._ratio = float(state["ratio"])
        self._pretrain_steps = int(state["pretrain_steps"])
        self._prev = None if state["prev"] is None else float(state["prev"])
        return self


def save_configs(cfg: Any, log_dir: str) -> None:
    os.makedirs(log_dir, exist_ok=True)
    as_dict = cfg.as_dict() if hasattr(cfg, "as_dict") else dict(cfg)
    with open(os.path.join(log_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(as_dict, f, sort_keys=False)
