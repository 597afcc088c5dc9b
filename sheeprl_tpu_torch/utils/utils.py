"""Small numeric helpers (counterparts of ``sheeprl_tpu/utils/utils.py``)."""

from __future__ import annotations

import numpy as np
import torch


def symlog(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def merge_framestack(x: np.ndarray) -> np.ndarray:
    """``(..., S, H, W, C)`` framestacked pixels -> ``(..., H, W, S*C)``."""
    s = x.shape
    x = np.moveaxis(x, -4, -2)  # (..., H, W, S, C)
    return x.reshape(*s[:-4], s[-3], s[-2], s[-4] * s[-1])
