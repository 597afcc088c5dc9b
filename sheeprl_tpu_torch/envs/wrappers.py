"""The environment wrappers ``make_env`` applies to the dummy envs (copies of
``sheeprl_tpu/envs/wrappers.py``, written without gymnasium)."""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, Sequence

import numpy as np

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.dummy import Env


class Wrapper(Env):
    def __init__(self, env: Env):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space

    def reset(self, **kwargs: Any):
        return self.env.reset(**kwargs)

    def step(self, action: Any):
        return self.env.step(action)

    def close(self) -> None:
        self.env.close()


class ActionRepeat(Wrapper):
    """Repeat each action ``amount`` times, summing rewards."""

    def __init__(self, env: Env, amount: int):
        super().__init__(env)
        if amount <= 0:
            raise ValueError(f"action_repeat must be positive, got {amount}")
        self._amount = int(amount)

    def step(self, action: Any):
        total_reward = 0.0
        obs, terminated, truncated, info = None, False, False, {}
        for _ in range(self._amount):
            obs, reward, terminated, truncated, info = self.env.step(action)
            total_reward += float(reward)
            if terminated or truncated:
                break
        return obs, total_reward, terminated, truncated, info


class RestartOnException(Wrapper):
    """Recreate a crashed environment; at most ``max_restarts`` within
    ``window`` seconds, then the exception propagates.  A restart sets
    ``info["restart_on_exception"]``."""

    def __init__(self, env_fn: Callable[[], Env], max_restarts: int = 5, window: float = 60.0):
        self._env_fn = env_fn
        self._max_restarts = max_restarts
        self._window = window
        self._restart_times: deque = deque()
        super().__init__(env_fn())

    def _restart(self) -> None:
        now = time.monotonic()
        while self._restart_times and now - self._restart_times[0] > self._window:
            self._restart_times.popleft()
        if len(self._restart_times) >= self._max_restarts:
            raise RuntimeError(
                f"Environment crashed {len(self._restart_times)} times within {self._window}s; giving up"
            )
        self._restart_times.append(now)
        try:
            self.env.close()
        except Exception:
            pass
        self.env = self._env_fn()

    def step(self, action: Any):
        try:
            return self.env.step(action)
        except Exception:
            self._restart()
            obs, info = self.env.reset()
            info = dict(info)
            info["restart_on_exception"] = True
            return obs, 0.0, False, False, info

    def reset(self, **kwargs: Any):
        try:
            return self.env.reset(**kwargs)
        except Exception:
            self._restart()
            obs, info = self.env.reset(**kwargs)
            info = dict(info)
            info["restart_on_exception"] = True
            return obs, info


class FrameStack(Wrapper):
    """Stack the last ``num_stack`` frames of every image key:
    ``(H, W, C)`` → ``(num_stack, H, W, C)``, with temporal ``dilation``."""

    def __init__(self, env: Env, num_stack: int, cnn_keys: Sequence[str], dilation: int = 1):
        super().__init__(env)
        if num_stack <= 0:
            raise ValueError(f"num_stack must be positive, got {num_stack}")
        self._num_stack = int(num_stack)
        self._dilation = int(dilation)
        self._cnn_keys = [k for k in cnn_keys if len(env.observation_space[k].shape) == 3]
        if not self._cnn_keys:
            raise RuntimeError(f"No image keys to stack among {list(cnn_keys)}")
        self._frames: Dict[str, deque] = {k: deque(maxlen=num_stack * dilation) for k in self._cnn_keys}
        new_spaces = dict(env.observation_space.spaces)
        for k in self._cnn_keys:
            sp = env.observation_space[k]
            new_spaces[k] = spaces.Box(
                np.repeat(sp.low[None], num_stack, axis=0),
                np.repeat(sp.high[None], num_stack, axis=0),
                (num_stack, *sp.shape),
                sp.dtype,
            )
        self.observation_space = spaces.Dict(new_spaces)

    def _observation(self, obs: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(obs)
        for k in self._cnn_keys:
            frames = list(self._frames[k])[:: -self._dilation][::-1]
            out[k] = np.stack(frames, axis=0)
        return out

    def step(self, action: Any):
        obs, reward, terminated, truncated, info = self.env.step(action)
        for k in self._cnn_keys:
            self._frames[k].append(obs[k])
        return self._observation(obs), reward, terminated, truncated, info

    def reset(self, **kwargs: Any):
        obs, info = self.env.reset(**kwargs)
        for k in self._cnn_keys:
            for _ in range(self._num_stack * self._dilation):
                self._frames[k].append(obs[k])
        return self._observation(obs), info


class TimeLimit(Wrapper):
    """Truncate episodes after ``max_episode_steps`` steps."""

    def __init__(self, env: Env, max_episode_steps: int):
        super().__init__(env)
        self._max = int(max_episode_steps)
        self._elapsed = 0

    def reset(self, **kwargs: Any):
        self._elapsed = 0
        return self.env.reset(**kwargs)

    def step(self, action: Any):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._elapsed += 1
        return obs, reward, terminated, truncated or self._elapsed >= self._max, info
