"""The environment wrappers of ``make_env`` (copies of
``sheeprl_tpu/envs/wrappers.py`` and of the gymnasium wrappers its
``make_env`` uses, written without gymnasium)."""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, Sequence

import numpy as np

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.dummy import Env
from sheeprl_tpu_torch.resilience.faults import fault_point
from sheeprl_tpu_torch.telemetry.monitors import RESILIENCE_MONITOR
from sheeprl_tpu_torch.telemetry.recorder import RECORDER


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


class FaultInjectionEnv(Wrapper):
    """Fire the ``env.step`` / ``env.reset`` fault sites
    (``resilience/faults.py``) around the wrapped env.  ``make_env`` adds it
    only when the active plan targets an ``env.*`` site, inside
    :class:`RestartOnException`, so an injected crash exercises the real
    restart path."""

    def step(self, action: Any):
        fault_point("env.step")
        return self.env.step(action)

    def reset(self, **kwargs: Any):
        fault_point("env.reset")
        return self.env.reset(**kwargs)


class RestartOnException(Wrapper):
    """Recreate a crashed environment; at most ``max_restarts`` within
    ``window`` seconds, then the exception propagates.  A restart sets
    ``info["restart_on_exception"]`` and counts in ``Resilience/env_restarts``."""

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
            # the exhausted restart budget kills the run: leave the evidence
            # now (the restart trail and this giveup), even if something
            # swallows the raise upstream
            RECORDER.record("watchdog.giveup", reason="env crashed", restarts=len(self._restart_times))
            RECORDER.dump("watchdog")
            raise RuntimeError(
                f"Environment crashed {len(self._restart_times)} times within {self._window}s; giving up"
            )
        self._restart_times.append(now)
        RESILIENCE_MONITOR.record_env_restart()
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


class MaskVelocityWrapper(Wrapper):
    """Zero the velocity components of a classic-control vector observation
    (a partially observable task).  Keyed on the gymnasium env id, as the
    JAX wrapper is: other envs raise."""

    velocity_indices: Dict[str, np.ndarray] = {
        "CartPole-v0": np.array([1, 3]),
        "CartPole-v1": np.array([1, 3]),
        "MountainCar-v0": np.array([1]),
        "MountainCarContinuous-v0": np.array([1]),
        "Pendulum-v1": np.array([2]),
        "LunarLander-v2": np.array([2, 3, 5]),
        "LunarLander-v3": np.array([2, 3, 5]),
        "LunarLanderContinuous-v2": np.array([2, 3, 5]),
        "LunarLanderContinuous-v3": np.array([2, 3, 5]),
    }

    def __init__(self, env: Env, env_id: str):
        super().__init__(env)
        if env_id not in self.velocity_indices:
            raise NotImplementedError(f"Velocity masking not implemented for {env_id}")
        self.mask = np.ones(env.observation_space.shape, dtype=np.float32)
        self.mask[self.velocity_indices[env_id]] = 0.0

    def reset(self, **kwargs: Any):
        obs, info = self.env.reset(**kwargs)
        return obs * self.mask, info

    def step(self, action: Any):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return obs * self.mask, reward, terminated, truncated, info


class RewardAsObservationWrapper(Wrapper):
    """The last reward as an extra ``reward`` observation key (0 after a reset)."""

    def __init__(self, env: Env):
        super().__init__(env)
        reward_space = spaces.Box(-np.inf, np.inf, (1,), np.float32)
        if isinstance(env.observation_space, spaces.Dict):
            new_spaces = {**env.observation_space.spaces, "reward": reward_space}
        else:
            new_spaces = {"obs": env.observation_space, "reward": reward_space}
        self.observation_space = spaces.Dict(new_spaces)

    @staticmethod
    def _wrap(obs: Any, reward: float) -> Dict[str, Any]:
        r = np.array([reward], dtype=np.float32)
        return {**obs, "reward": r} if isinstance(obs, dict) else {"obs": obs, "reward": r}

    def step(self, action: Any):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return self._wrap(obs, float(reward)), reward, terminated, truncated, info

    def reset(self, **kwargs: Any):
        obs, info = self.env.reset(**kwargs)
        return self._wrap(obs, 0.0), info


class ActionsAsObservationWrapper(Wrapper):
    """The last ``num_stack`` actions (every ``dilation``-th) as an
    ``action_stack`` observation key: one-hot for discrete actions, the
    concatenated one-hots of a multi-discrete one, continuous ones as they
    are; a reset fills the stack with ``noop``."""

    def __init__(self, env: Env, num_stack: int, noop: Any, dilation: int = 1):
        super().__init__(env)
        if num_stack <= 0:
            raise ValueError(f"num_stack must be positive, got {num_stack}")
        if dilation <= 0:
            raise ValueError(f"dilation must be positive, got {dilation}")
        self._num_stack = num_stack
        self._dilation = dilation
        act_space = env.action_space
        if isinstance(act_space, spaces.Discrete):
            self._per_action = int(act_space.n)
        elif isinstance(act_space, spaces.MultiDiscrete):
            self._per_action = int(np.sum(act_space.nvec))
        elif isinstance(act_space, spaces.Box):
            self._per_action = int(np.prod(act_space.shape))
        else:
            raise RuntimeError(f"Unsupported action space {type(act_space)}")
        self._noop = noop
        self._actions: deque = deque(maxlen=num_stack * dilation)
        action_obs_space = spaces.Box(-np.inf, np.inf, (num_stack * self._per_action,), np.float32)
        if isinstance(env.observation_space, spaces.Dict):
            new_spaces = {**env.observation_space.spaces, "action_stack": action_obs_space}
        else:
            new_spaces = {"obs": env.observation_space, "action_stack": action_obs_space}
        self.observation_space = spaces.Dict(new_spaces)

    def _encode(self, action: Any) -> np.ndarray:
        act_space = self.env.action_space
        if isinstance(act_space, spaces.Discrete):
            out = np.zeros(self._per_action, dtype=np.float32)
            out[int(np.asarray(action).reshape(()))] = 1.0
            return out
        if isinstance(act_space, spaces.MultiDiscrete):
            parts = []
            for a, n in zip(np.asarray(action).flatten(), act_space.nvec):
                oh = np.zeros(int(n), dtype=np.float32)
                oh[int(a)] = 1.0
                parts.append(oh)
            return np.concatenate(parts)
        return np.asarray(action, dtype=np.float32).flatten()

    def _obs_with_actions(self, obs: Any) -> Dict[str, Any]:
        actions = list(self._actions)[:: -self._dilation][::-1]
        stack = np.concatenate([self._encode(a) for a in actions])
        return {**obs, "action_stack": stack} if isinstance(obs, dict) else {"obs": obs, "action_stack": stack}

    def step(self, action: Any):
        self._actions.append(action)
        obs, reward, terminated, truncated, info = self.env.step(action)
        return self._obs_with_actions(obs), reward, terminated, truncated, info

    def reset(self, **kwargs: Any):
        obs, info = self.env.reset(**kwargs)
        for _ in range(self._num_stack * self._dilation):
            self._actions.append(self._noop)
        return self._obs_with_actions(obs), info


class TransformReward(Wrapper):
    """``fn`` of every step's reward (``env.clip_rewards``: ``tanh``)."""

    def __init__(self, env: Env, fn: Callable[[float], float]):
        super().__init__(env)
        self._fn = fn

    def step(self, action: Any):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return obs, self._fn(reward), terminated, truncated, info
