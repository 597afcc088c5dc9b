"""One device env behind the port's ``Env`` API (counterpart of
``sheeprl_tpu/envs/jax/adapter.py``).

Every host loop of the port (on- and off-policy, the Dreamer family) runs a
device env through ``make_env`` like any other suite: this adapter steps one
instance on its device and hands back host numpy observations, a float
reward and the two flags.

The device is explicit: ``make_env`` passes the run's device, and the CPU
only when the caller asks for it.  Seeding follows the gymnasium contract
as the JAX adapter does: ``reset(seed=s)`` restarts the env's generator from
``s``; a reset without a seed goes on with the stream; with no seed ever
given, the first reset seeds the generator from ``np_random``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.envs.device.core import DeviceEnv
from sheeprl_tpu_torch.envs.dummy import Env


class DeviceEnvAdapter(Env):
    def __init__(self, env: DeviceEnv, device: Any, seed: Optional[int] = None):
        self._env = env
        self.device = torch.device(device)
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        self._state = None
        self._generator: Optional[torch.Generator] = None
        if seed is not None:
            self._generator = torch.Generator(self.device).manual_seed(int(seed))

    def _host_obs(self, obs: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        return {k: v[0].cpu().numpy() for k, v in obs.items()}

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        super().reset(seed=seed)
        if seed is not None:
            self._generator = torch.Generator(self.device).manual_seed(int(seed))
        elif self._generator is None:
            self._generator = torch.Generator(self.device).manual_seed(int(self.np_random.integers(2**31 - 1)))
        self._state, obs = self._env.reset(1, self._generator, self.device)
        return self._host_obs(obs), {}

    def step(self, action: Any):
        action = torch.as_tensor(np.asarray(action), device=self.device).reshape(1, -1)
        self._state, obs, reward, terminated, truncated = self._env.step(self._state, action)
        return self._host_obs(obs), float(reward[0]), bool(terminated[0]), bool(truncated[0]), {}

    def render(self) -> Optional[np.ndarray]:
        if self._state is not None and "rgb" in self.observation_space.spaces:
            return self._env.observe(self._state)["rgb"][0].cpu().numpy()
        return None
