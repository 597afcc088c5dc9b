"""Pendulum on the device (counterpart of ``sheeprl_tpu/envs/jax/pendulum.py``).

Gymnasium's ``Pendulum-v1`` as the JAX env has it, in fp32: semi-implicit
Euler with the speed clipped to ±8, the quadratic cost on the normalised
angle, the speed and the torque, the 200-step limit as an in-env
``truncated`` flag, and no termination.  A reset draws the angle from
U(-π, π) and the speed from U(-1, 1).  ``level`` shrinks the torque limit to
``MAX_TORQUE / (1 + level)``; the action space stays ±2.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.device.core import DeviceEnv, Obs


def angle_normalize(x: torch.Tensor) -> torch.Tensor:
    return ((x + math.pi) % (2 * math.pi)) - math.pi


class PendulumState(NamedTuple):
    theta: torch.Tensor  # (n,)
    theta_dot: torch.Tensor  # (n,)
    t: torch.Tensor  # (n,) int32 step counter
    level: torch.Tensor  # (n,) fp32 difficulty (torque limit)


class Pendulum(DeviceEnv):
    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    DT = 0.05
    M = 1.0
    L = 1.0

    def __init__(self, max_episode_steps: int = 200, g: float = 10.0, level: float = 0.0):
        self.max_episode_steps = int(max_episode_steps)
        self.g = float(g)
        self.level = float(level)
        high = np.array([1.0, 1.0, self.MAX_SPEED], dtype=np.float32)
        self.observation_space = spaces.Dict({"state": spaces.Box(-high, high, dtype=np.float32)})
        self.action_space = spaces.Box(-self.MAX_TORQUE, self.MAX_TORQUE, (1,), np.float32)

    def draw_reset(self, n: int, generator: torch.Generator, device: torch.device) -> Dict[str, torch.Tensor]:
        u = torch.rand((n, 2), generator=generator, device=device)
        return {"init": torch.stack([u[:, 0] * (2 * math.pi) - math.pi, u[:, 1] * 2.0 - 1.0], dim=-1)}

    def reset_from(self, draws: Dict[str, torch.Tensor]) -> PendulumState:
        init = draws["init"].to(torch.float32)
        n = init.shape[0]
        return PendulumState(theta=init[:, 0], theta_dot=init[:, 1],
                             t=torch.zeros(n, dtype=torch.int32, device=init.device),
                             level=torch.full((n,), self.level, dtype=torch.float32, device=init.device))

    def observe(self, state: PendulumState) -> Obs:
        return {"state": torch.stack([torch.cos(state.theta), torch.sin(state.theta), state.theta_dot], dim=-1)}

    def step(self, state: PendulumState, action: torch.Tensor):
        max_torque = self.MAX_TORQUE / (1.0 + state.level)
        u = torch.clamp(action.reshape(-1).to(torch.float32), -max_torque, max_torque)
        th, thdot = state.theta, state.theta_dot
        costs = angle_normalize(th) ** 2 + 0.1 * thdot**2 + 0.001 * u**2
        newthdot = thdot + (3.0 * self.g / (2.0 * self.L) * torch.sin(th) + 3.0 / (self.M * self.L**2) * u) * self.DT
        newthdot = torch.clamp(newthdot, -self.MAX_SPEED, self.MAX_SPEED)
        newth = th + newthdot * self.DT
        t = state.t + 1
        new_state = PendulumState(theta=newth, theta_dot=newthdot, t=t, level=state.level)
        terminated = torch.zeros_like(t, dtype=torch.bool)  # the pendulum never terminates
        return new_state, self.observe(new_state), -costs, terminated, t >= self.max_episode_steps
