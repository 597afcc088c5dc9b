"""The pixel foraging gridworld on the device (counterpart of
``sheeprl_tpu/envs/jax/forage.py``).

A ``grid x grid`` world rendered on the device as an ``(H, W, 3)`` uint8
frame: the agent is a white cell, food cells are green.  A reset permutes
the grid's cells: the first cell of the permutation is the agent, the next
``n_food`` are food, so nothing collides.  ``torch.randperm`` draws one
permutation at a time, so the batch's permutations are an ``argsort`` of
uniform draws, one row per instance.  Actions are noop/up/down/left/right;
eating food pays +1; the episode terminates when no food is left and
truncates at ``max_episode_steps``.  The position and the food show only in
the pixels.

``level`` is resolved at construction, because the grid is a shape: each
whole level doubles the grid while the image stays a multiple of it.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.device.core import DeviceEnv, Obs

# noop/up/down/left/right
MOVES = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
FOOD_RGB = (0, 255, 0)


def cell_mask(pos: torch.Tensor, grid: int) -> torch.Tensor:
    """``(n, grid, grid)`` one-hot of each row's ``(row, col)`` cell."""
    idx = torch.arange(grid, device=pos.device)
    return (idx[None, :, None] == pos[:, 0, None, None]) & (idx[None, None, :] == pos[:, 1, None, None])


def upsample(cells: torch.Tensor, cell: int) -> torch.Tensor:
    """``(n, G, G, C)`` → ``(n, G·cell, G·cell, C)`` by pixel repeat."""
    n, g, _, c = cells.shape
    return cells[:, :, None, :, None, :].expand(n, g, cell, g, cell, c).reshape(n, g * cell, g * cell, c)


def apply_moves(moves: torch.Tensor, pos: torch.Tensor, action: torch.Tensor, grid: int) -> torch.Tensor:
    """The clipped cell each row's noop/up/down/left/right leads to (``moves``
    is the table :data:`MOVES` on the device)."""
    return torch.clamp(pos + moves[action.reshape(-1).long() % 5], 0, grid - 1)


class ForageState(NamedTuple):
    pos: torch.Tensor  # (n, 2) int32 agent cell (row, col)
    food: torch.Tensor  # (n, grid, grid) bool remaining food
    t: torch.Tensor  # (n,) int32 step counter


class Forage(DeviceEnv):
    CONSTANTS = {"moves": (MOVES, torch.int32), "food": (FOOD_RGB, torch.uint8)}

    def __init__(self, grid: int = 8, n_food: int = 6, image_hw: int = 64, max_episode_steps: int = 128,
                 level: float = 0.0):
        self.level = float(level)
        grid = int(grid)
        for _ in range(max(0, int(self.level))):
            if grid * 2 <= image_hw and image_hw % (grid * 2) == 0:
                grid *= 2
        if image_hw % grid != 0:
            raise ValueError(f"image_hw ({image_hw}) must be a multiple of grid ({grid})")
        if n_food >= grid * grid:
            raise ValueError(f"n_food ({n_food}) must leave room for the agent on a {grid}x{grid} grid")
        self.grid = grid
        self.n_food = int(n_food)
        self.image_hw = int(image_hw)
        self.cell = self.image_hw // self.grid
        self.max_episode_steps = int(max_episode_steps)
        self.observation_space = spaces.Dict({"rgb": spaces.Box(0, 255, (image_hw, image_hw, 3), np.uint8)})
        self.action_space = spaces.Discrete(5)

    def draw_reset(self, n: int, generator: torch.Generator, device: torch.device) -> Dict[str, torch.Tensor]:
        u = torch.rand((n, self.grid * self.grid), generator=generator, device=device)
        return {"cells": torch.argsort(u, dim=1)}

    def reset_from(self, draws: Dict[str, torch.Tensor]) -> ForageState:
        cells = draws["cells"].long()
        n, g = cells.shape[0], self.grid
        agent = cells[:, 0]
        pos = torch.stack([agent // g, agent % g], dim=-1).to(torch.int32)
        food = torch.zeros((n, g * g), dtype=torch.bool, device=cells.device)
        food = food.scatter(1, cells[:, 1:1 + self.n_food], True).reshape(n, g, g)
        return ForageState(pos=pos, food=food, t=torch.zeros(n, dtype=torch.int32, device=cells.device))

    def observe(self, state: ForageState) -> Obs:
        # green food, a white agent on top of whatever its cell holds
        img = state.food[..., None].to(torch.uint8) * self.const("food", state.food.device)
        img = torch.where(cell_mask(state.pos, self.grid)[..., None], torch.full_like(img, 255), img)
        return {"rgb": upsample(img, self.cell)}

    def step(self, state: ForageState, action: torch.Tensor):
        pos = apply_moves(self.const("moves", state.pos.device), state.pos, action, self.grid)
        here = cell_mask(pos, self.grid)
        ate = (state.food & here).any(dim=(1, 2))
        food = state.food & ~here
        t = state.t + 1
        new_state = ForageState(pos=pos, food=food, t=t)
        terminated = ~food.any(dim=(1, 2))
        truncated = (t >= self.max_episode_steps) & ~terminated
        return new_state, self.observe(new_state), ate.to(torch.float32), terminated, truncated
