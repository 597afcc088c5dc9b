"""Minimal observation and action spaces.

The port's environments need only what the serving path reads from a
space: ``shape``, ``dtype``, ``sample()``, the bounds of a ``Box``, ``n`` /
``nvec`` of the discrete spaces, and the keys of a ``Dict``.  They are kept
here rather than taken from gymnasium so that the port runs on a CUDA host
that has no gymnasium installed.  Names and attributes follow
``gymnasium.spaces``.
"""

from __future__ import annotations

from typing import Any, Dict as TDict, Iterable, Optional, Sequence, Tuple

import numpy as np


class Space:
    def __init__(self, shape: Tuple[int, ...], dtype: Any, seed: Optional[int] = None):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.np_random = np.random.default_rng(seed)

    def seed(self, seed: Optional[int] = None) -> None:
        self.np_random = np.random.default_rng(seed)

    def sample(self) -> Any:
        raise NotImplementedError


class Box(Space):
    def __init__(self, low: Any, high: Any, shape: Optional[Sequence[int]] = None, dtype: Any = np.float32):
        if shape is None:
            shape = np.shape(low)
        super().__init__(shape, dtype)
        self.low = np.broadcast_to(np.asarray(low, self.dtype), self.shape).copy()
        self.high = np.broadcast_to(np.asarray(high, self.dtype), self.shape).copy()

    def sample(self) -> np.ndarray:
        low = np.where(np.isfinite(self.low), self.low, -1.0)
        high = np.where(np.isfinite(self.high), self.high, 1.0)
        return self.np_random.uniform(low, high).astype(self.dtype)


class Discrete(Space):
    def __init__(self, n: int):
        super().__init__((), np.int64)
        self.n = int(n)

    def sample(self) -> np.int64:
        return np.int64(self.np_random.integers(self.n))


class MultiDiscrete(Space):
    def __init__(self, nvec: Iterable[int]):
        self.nvec = np.asarray(list(nvec), np.int64)
        super().__init__(self.nvec.shape, np.int64)

    def sample(self) -> np.ndarray:
        return self.np_random.integers(self.nvec).astype(np.int64)


class Dict(Space):
    def __init__(self, spaces: TDict[str, Space]):
        super().__init__((), object)
        self.spaces = dict(spaces)

    def __getitem__(self, key: str) -> Space:
        return self.spaces[key]
