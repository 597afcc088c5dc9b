"""CartPole on the device (counterpart of ``sheeprl_tpu/envs/jax/cartpole.py``).

Gymnasium's ``CartPole-v1`` dynamics as the JAX env has them: fp32 (not
gymnasium's float64), Euler integration, the 12° and 2.4 m limits, +1 every
step including the terminating one, and the 500-step limit as an in-env
``truncated`` flag.  A reset draws the four state components from
U(-0.05, 0.05).  ``level`` (one fp32 per row) scales gravity by
``1 + 0.5·level`` and the pole's half-length by ``1 + level``; at 0 every
factor is exactly 1.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.device.core import DeviceEnv, Obs


class CartPoleState(NamedTuple):
    x: torch.Tensor  # (n,) cart position
    x_dot: torch.Tensor  # (n,) cart velocity
    theta: torch.Tensor  # (n,) pole angle (rad)
    theta_dot: torch.Tensor  # (n,) pole angular velocity
    t: torch.Tensor  # (n,) int32 step counter
    level: torch.Tensor  # (n,) fp32 difficulty (gravity / pole length)


class CartPole(DeviceEnv):
    GRAVITY = 9.8
    MASSCART = 1.0
    MASSPOLE = 0.1
    TOTAL_MASS = MASSPOLE + MASSCART
    LENGTH = 0.5  # half the pole's length
    FORCE_MAG = 10.0
    TAU = 0.02
    THETA_THRESHOLD = 12 * 2 * math.pi / 360
    X_THRESHOLD = 2.4

    def __init__(self, max_episode_steps: int = 500, level: float = 0.0):
        self.max_episode_steps = int(max_episode_steps)
        self.level = float(level)
        high = np.array([self.X_THRESHOLD * 2, np.inf, self.THETA_THRESHOLD * 2, np.inf], dtype=np.float32)
        self.observation_space = spaces.Dict({"state": spaces.Box(-high, high, dtype=np.float32)})
        self.action_space = spaces.Discrete(2)

    def draw_reset(self, n: int, generator: torch.Generator, device: torch.device) -> Dict[str, torch.Tensor]:
        u = torch.rand((n, 4), generator=generator, device=device)
        return {"init": u * 0.1 - 0.05}

    def reset_from(self, draws: Dict[str, torch.Tensor]) -> CartPoleState:
        init = draws["init"].to(torch.float32)
        n = init.shape[0]
        return CartPoleState(x=init[:, 0], x_dot=init[:, 1], theta=init[:, 2], theta_dot=init[:, 3],
                             t=torch.zeros(n, dtype=torch.int32, device=init.device),
                             level=torch.full((n,), self.level, dtype=torch.float32, device=init.device))

    def observe(self, state: CartPoleState) -> Obs:
        return {"state": torch.stack([state.x, state.x_dot, state.theta, state.theta_dot], dim=-1)}

    def step(self, state: CartPoleState, action: torch.Tensor):
        lvl = state.level
        gravity = self.GRAVITY * (1.0 + 0.5 * lvl)
        length = self.LENGTH * (1.0 + lvl)
        polemass_length = self.MASSPOLE * length
        force = torch.where(action.reshape(-1).to(torch.int32) == 1, self.FORCE_MAG, -self.FORCE_MAG)
        costheta = torch.cos(state.theta)
        sintheta = torch.sin(state.theta)
        # gymnasium's Euler step, in the JAX env's fp32 and operation order
        temp = (force + polemass_length * state.theta_dot**2 * sintheta) / self.TOTAL_MASS
        thetaacc = (gravity * sintheta - costheta * temp) / (
            length * (4.0 / 3.0 - self.MASSPOLE * costheta**2 / self.TOTAL_MASS)
        )
        xacc = temp - polemass_length * thetaacc * costheta / self.TOTAL_MASS
        x = state.x + self.TAU * state.x_dot
        x_dot = state.x_dot + self.TAU * xacc
        theta = state.theta + self.TAU * state.theta_dot
        theta_dot = state.theta_dot + self.TAU * thetaacc
        t = state.t + 1
        terminated = (torch.abs(x) > self.X_THRESHOLD) | (torch.abs(theta) > self.THETA_THRESHOLD)
        truncated = (t >= self.max_episode_steps) & ~terminated
        new_state = CartPoleState(x=x, x_dot=x_dot, theta=theta, theta_dot=theta_dot, t=t, level=state.level)
        reward = torch.ones_like(x)  # +1 every step, including the terminating one
        return new_state, self.observe(new_state), reward, terminated, truncated
