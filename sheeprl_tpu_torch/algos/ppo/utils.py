"""Action-space helpers the serving players share (from
``sheeprl_tpu/algos/ppo/utils.py``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from sheeprl_tpu_torch.envs import spaces


def actions_for_env(actions: np.ndarray, action_space: spaces.Space) -> np.ndarray:
    """Stored float actions → what the env expects."""
    if isinstance(action_space, spaces.Discrete):
        return actions.astype(np.int64).reshape(-1)
    if isinstance(action_space, spaces.MultiDiscrete):
        return actions.astype(np.int64)
    low = np.asarray(action_space.low, np.float32)
    high = np.asarray(action_space.high, np.float32)
    return np.clip(actions.astype(np.float32), low, high)


def spaces_to_dims(action_space: spaces.Space) -> Tuple[Tuple[int, ...], bool]:
    """Action-space → (per-branch dims, is_continuous)."""
    if isinstance(action_space, spaces.Discrete):
        return (int(action_space.n),), False
    if isinstance(action_space, spaces.MultiDiscrete):
        return tuple(int(n) for n in action_space.nvec), False
    if isinstance(action_space, spaces.Box):
        return (int(np.prod(action_space.shape)),), True
    raise ValueError(f"Unsupported action space {type(action_space)}")
