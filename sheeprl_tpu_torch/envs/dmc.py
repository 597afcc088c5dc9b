"""DeepMind Control Suite tasks behind the port's ``Env`` API (counterpart
of ``sheeprl_tpu/envs/dmc.py``).

A ``dm_control`` task with a Dict observation space: the rendered pixels
under ``rgb`` and the proprioceptive readings, flattened and concatenated,
under ``state``.  ``dm_control`` is imported when a task is built, so a
machine without it runs every other env.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Optional

import numpy as np

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.dummy import Env


class DMCWrapper(Env):
    def __init__(self, env_id: str, seed: Optional[int] = None, from_pixels: bool = True,
                 from_vectors: bool = False, width: int = 64, height: int = 64, camera_id: int = 0):
        # headless hosts have no display for MuJoCo's default glfw backend;
        # EGL renders without one (Linux only)
        if sys.platform.startswith("linux") and "MUJOCO_GL" not in os.environ and not os.environ.get("DISPLAY"):
            os.environ["MUJOCO_GL"] = "egl"
        try:
            from dm_control import suite
        except ImportError as e:
            raise ImportError("DMC environments need the 'dm_control' package, which is not installed") from e
        domain, task = env_id.replace("_", " ").split(" ", 1) if "_" in env_id else env_id.split("-", 1)
        self._env = suite.load(domain, task.replace(" ", "_"), task_kwargs={"random": seed})
        self._from_pixels = from_pixels
        self._width, self._height, self._camera = width, height, camera_id
        act_spec = self._env.action_spec()
        self.action_space = spaces.Box(act_spec.minimum.astype(np.float32), act_spec.maximum.astype(np.float32))
        obs_spaces: Dict[str, spaces.Space] = {}
        if from_pixels:
            obs_spaces["rgb"] = spaces.Box(0, 255, (height, width, 3), np.uint8)
        if from_vectors or not from_pixels:
            dim = int(sum(np.prod(v.shape) for v in self._env.observation_spec().values()))
            obs_spaces["state"] = spaces.Box(-np.inf, np.inf, (dim,), np.float32)
        self.observation_space = spaces.Dict(obs_spaces)

    def _obs(self, timestep) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        if self._from_pixels:
            out["rgb"] = self.render()
        if "state" in self.observation_space.spaces:
            out["state"] = np.concatenate(
                [np.asarray(v, np.float32).reshape(-1) for v in timestep.observation.values()])
        return out

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        super().reset(seed=seed)
        return self._obs(self._env.reset()), {}

    def step(self, action):
        timestep = self._env.step(np.asarray(action))
        terminated = timestep.last() and timestep.discount == 0.0
        truncated = timestep.last() and not terminated
        return self._obs(timestep), float(timestep.reward or 0.0), terminated, truncated, {}

    def render(self) -> np.ndarray:
        return self._env.physics.render(self._height, self._width, camera_id=self._camera)
