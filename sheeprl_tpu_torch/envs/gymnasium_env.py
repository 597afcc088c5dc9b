"""A gymnasium env behind the port's ``Env`` API.

``make_env`` builds a ``wrapper.kind: gym`` env through ``gymnasium.make``
and puts it behind this adapter, its spaces translated to the port's own
(:mod:`~sheeprl_tpu_torch.envs.spaces`).  gymnasium is imported only when
such an env is built: a machine without it runs every other env.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.dummy import Env


def space_from_gymnasium(space: Any) -> spaces.Space:
    """The port's counterpart of a gymnasium ``Box``, ``Discrete``,
    ``MultiDiscrete`` or ``Dict`` space."""
    from gymnasium import spaces as gym_spaces

    if isinstance(space, gym_spaces.Dict):
        return spaces.Dict({k: space_from_gymnasium(v) for k, v in space.spaces.items()})
    if isinstance(space, gym_spaces.Box):
        return spaces.Box(space.low, space.high, space.shape, space.dtype)
    if isinstance(space, gym_spaces.Discrete):
        return spaces.Discrete(int(space.n))
    if isinstance(space, gym_spaces.MultiDiscrete):
        return spaces.MultiDiscrete(space.nvec)
    raise NotImplementedError(f"gymnasium space {type(space).__name__} has no counterpart in the port")


class GymnasiumEnv(Env):
    def __init__(self, env_id: str, render_mode: Optional[str] = None, **kwargs: Any):
        import gymnasium as gym

        self.env_id = env_id
        self._env = gym.make(env_id, render_mode=render_mode, **kwargs)
        self.observation_space = space_from_gymnasium(self._env.observation_space)
        self.action_space = space_from_gymnasium(self._env.action_space)

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        super().reset(seed=seed)
        return self._env.reset(seed=seed, options=options)

    def step(self, action: Any):
        obs, reward, terminated, truncated, info = self._env.step(np.asarray(action))
        return obs, float(reward), bool(terminated), bool(truncated), dict(info)

    @property
    def metadata(self) -> Dict[str, Any]:
        return self._env.metadata

    def render(self) -> Any:
        return self._env.render()

    def close(self) -> None:
        self._env.close()
