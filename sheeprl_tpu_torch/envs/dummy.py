"""Deterministic dummy environments (copy of ``sheeprl_tpu/envs/dummy.py``).

Dict observations (an ``rgb`` image, channel-last ``(H, W, C)``, and a
``state`` vector), fixed-length episodes, discrete / multi-discrete /
continuous action variants, and the learnable pixel-grid task.  Written
against the port's own :mod:`~sheeprl_tpu_torch.envs.spaces` and the
gymnasium ``reset``/``step`` signatures.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from sheeprl_tpu_torch.envs import spaces


class Env:
    """The gymnasium ``Env`` surface the port's wrappers and loaders use."""

    observation_space: spaces.Space
    action_space: spaces.Space
    metadata: Dict[str, Any] = {}

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        if seed is not None or not hasattr(self, "np_random"):
            self.np_random = np.random.default_rng(seed)
        return None, {}

    def step(self, action: Any):
        raise NotImplementedError

    def render(self) -> Any:
        raise NotImplementedError(f"{type(self).__name__} does not render")

    def close(self) -> None:
        pass


class _DummyEnv(Env):
    metadata = {"render_modes": ["rgb_array"]}
    render_mode = "rgb_array"

    def __init__(
        self,
        image_size: Tuple[int, int, int] = (64, 64, 3),
        episode_len: int = 128,
        random_start: bool = False,
    ):
        self._image_size = tuple(image_size)
        self._episode_len = episode_len
        self._random_start = bool(random_start)
        self._step = 0
        self.observation_space = spaces.Dict(
            {
                "rgb": spaces.Box(0, 255, self._image_size, np.uint8),
                "state": spaces.Box(-np.inf, np.inf, (4,), np.float32),
            }
        )
        self.reward_range = (0.0, 1.0)

    def _obs(self) -> Dict[str, np.ndarray]:
        return {
            "rgb": np.full(self._image_size, self._step % 256, dtype=np.uint8),
            "state": np.full((4,), self._step, dtype=np.float32),
        }

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        super().reset(seed=seed)
        self._step = (
            int(self.np_random.integers(self._episode_len // 2)) if self._random_start else 0
        )
        return self._obs(), {}

    def step(self, action: Any):
        self._step += 1
        done = self._step >= self._episode_len
        return self._obs(), 1.0, done, False, {}

    def render(self) -> np.ndarray:
        return self._obs()["rgb"]


class DiscreteDummyEnv(_DummyEnv):
    def __init__(self, *args: Any, **kwargs: Any):
        super().__init__(*args, **kwargs)
        self.action_space = spaces.Discrete(4)


class MultiDiscreteDummyEnv(_DummyEnv):
    def __init__(self, *args: Any, **kwargs: Any):
        super().__init__(*args, **kwargs)
        self.action_space = spaces.MultiDiscrete([4, 3])


class ContinuousDummyEnv(_DummyEnv):
    def __init__(self, *args: Any, **kwargs: Any):
        super().__init__(*args, **kwargs)
        self.action_space = spaces.Box(-1.0, 1.0, (2,), np.float32)


class PixelGridDummyEnv(Env):
    """A learnable pixel task: the agent (white patch) walks a ``grid x grid``
    world towards a fixed green goal; reward is the negative normalised
    Manhattan distance.  The position shows only in the pixels."""

    metadata = {"render_modes": ["rgb_array"]}
    render_mode = "rgb_array"

    def __init__(self, grid: int = 4, episode_len: int = 16, image_hw: int = 64):
        self._grid = grid
        self._cell = image_hw // grid
        self._episode_len = episode_len
        self._hw = image_hw
        self._goal = (grid - 1, grid - 1)
        self._pos = [0, 0]
        self._step_count = 0
        self.observation_space = spaces.Dict(
            {
                "rgb": spaces.Box(0, 255, (image_hw, image_hw, 3), np.uint8),
                "state": spaces.Box(-np.inf, np.inf, (4,), np.float32),
            }
        )
        self.action_space = spaces.Discrete(5)
        self.reward_range = (-1.0, 0.0)

    def _obs(self) -> Dict[str, np.ndarray]:
        img = np.zeros((self._hw, self._hw, 3), np.uint8)
        c = self._cell
        gy, gx = self._goal
        img[gy * c : (gy + 1) * c, gx * c : (gx + 1) * c, 1] = 255
        y, x = self._pos
        img[y * c : (y + 1) * c, x * c : (x + 1) * c, :] = 255
        return {"rgb": img, "state": np.zeros((4,), np.float32)}

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        super().reset(seed=seed)
        self._step_count = 0
        while True:
            self._pos = [int(self.np_random.integers(self._grid)) for _ in range(2)]
            if tuple(self._pos) != self._goal:
                break
        return self._obs(), {}

    def step(self, action: Any):
        self._step_count += 1
        a = int(np.asarray(action).reshape(-1)[0])
        dy, dx = [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)][a % 5]
        self._pos[0] = int(np.clip(self._pos[0] + dy, 0, self._grid - 1))
        self._pos[1] = int(np.clip(self._pos[1] + dx, 0, self._grid - 1))
        dist = abs(self._pos[0] - self._goal[0]) + abs(self._pos[1] - self._goal[1])
        reward = -dist / (2 * (self._grid - 1))
        done = self._step_count >= self._episode_len
        return self._obs(), float(reward), False, done, {}

    def render(self) -> np.ndarray:
        return self._obs()["rgb"]
