"""The multi-room pixel gridworld on the device (counterpart of
``sheeprl_tpu/envs/jax/multiroom.py``).

A ``grid x grid`` board split into rooms by vertical walls at the quarter
columns; each wall has one door, locked until the agent steps on that wall's
key, which lies left of the wall, so every layout is completable.  Food pays
+0.1, a key +0.2, the goal in the last column +1 and ends the episode;
``max_episode_steps`` truncates.  A reset draws the door rows, the start
row, the goal row, the key rows and columns and the food rows and columns
(the JAX env's eight key splits, the last of which is its carry);
``reset_from`` builds the layout from those draws.  Walls are gray, locked
doors red, open doors dark gray, keys yellow, food green, the goal blue and
the agent white.

``level`` (one fp32 per row) sets the active wall count, ``1 + floor(level)``
clamped to 3: two rooms at 0, four from 2 on.  An inactive wall is floor.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.device.core import DeviceEnv, Obs
from sheeprl_tpu_torch.envs.device.forage import FOOD_RGB, MOVES, apply_moves, cell_mask, upsample

WALL_RGB = (128, 128, 128)
DOOR_RGB = (200, 0, 0)  # locked
OPEN_RGB = (60, 60, 60)  # unlocked passage
KEY_RGB = (255, 255, 0)
GOAL_RGB = (0, 0, 255)
AGENT_RGB = (255, 255, 255)
MAX_WALLS = 3  # four rooms


class MultiRoomState(NamedTuple):
    pos: torch.Tensor  # (n, 2) int32 agent cell (row, col)
    door_row: torch.Tensor  # (n, 3) int32 door row of each wall
    door_open: torch.Tensor  # (n, 3) bool unlocked doors
    key_taken: torch.Tensor  # (n, 3) bool collected keys
    key_pos: torch.Tensor  # (n, 3, 2) int32 key cells
    food: torch.Tensor  # (n, grid, grid) bool remaining food
    goal: torch.Tensor  # (n, 2) int32 goal cell (last column)
    t: torch.Tensor  # (n,) int32 step counter
    level: torch.Tensor  # (n,) fp32 difficulty (active room count)


class MultiRoom(DeviceEnv):
    CONSTANTS = {"moves": (MOVES, torch.int32),
                 **{name: (rgb, torch.uint8) for name, rgb in (("wall", WALL_RGB), ("door", DOOR_RGB),
                                                               ("open", OPEN_RGB), ("key", KEY_RGB),
                                                               ("food", FOOD_RGB), ("goal", GOAL_RGB),
                                                               ("agent", AGENT_RGB))}}

    def __init__(self, grid: int = 8, n_food: int = 4, image_hw: int = 64, max_episode_steps: int = 256,
                 level: float = 0.0):
        grid = int(grid)
        if grid < 8:
            raise ValueError(f"grid ({grid}) must be >= 8 to fit 4 rooms")
        if image_hw % grid != 0:
            raise ValueError(f"image_hw ({image_hw}) must be a multiple of grid ({grid})")
        self.grid = grid
        self.n_food = int(n_food)
        self.image_hw = int(image_hw)
        self.cell = self.image_hw // self.grid
        self.max_episode_steps = int(max_episode_steps)
        self.level = float(level)
        self.wall_cols = (grid // 4, grid // 2, (3 * grid) // 4)
        self.observation_space = spaces.Dict({"rgb": spaces.Box(0, 255, (image_hw, image_hw, 3), np.uint8)})
        self.action_space = spaces.Discrete(5)

    def _n_walls(self, level: torch.Tensor) -> torch.Tensor:
        """``(n,)`` active wall count, 1 + floor(level) in [1, 3]."""
        return 1 + torch.clamp(torch.floor(level).to(torch.int32), 0, MAX_WALLS - 1)

    def _off_wall(self, cols: torch.Tensor) -> torch.Tensor:
        """Columns on a wall moved one left (every wall column minus one is floor)."""
        on_wall = torch.zeros_like(cols, dtype=torch.bool)
        for c in self.wall_cols:
            on_wall = on_wall | (cols == c)
        return torch.where(on_wall, cols - 1, cols)

    def draw_reset(self, n: int, generator: torch.Generator, device: torch.device) -> Dict[str, torch.Tensor]:
        g = self.grid

        def randint(high, shape):
            return torch.randint(0, high, shape, generator=generator, device=device, dtype=torch.int32)

        return {
            "door_row": randint(g, (n, MAX_WALLS)),
            "start_row": randint(g, (n,)),
            "goal_row": randint(g, (n,)),
            "key_row": randint(g, (n, MAX_WALLS)),
            # key w in a column left of wall w
            "key_col": torch.stack([randint(c, (n,)) for c in self.wall_cols], dim=1),
            "food_row": randint(g, (n, self.n_food)),
            "food_col": randint(g, (n, self.n_food)),
        }

    def reset_from(self, draws: Dict[str, torch.Tensor]) -> MultiRoomState:
        d = {k: v.to(torch.int32) for k, v in draws.items()}
        g, dev = self.grid, d["door_row"].device
        n = d["door_row"].shape[0]
        key_pos = torch.stack([d["key_row"], self._off_wall(d["key_col"])], dim=-1)
        food_idx = (d["food_row"] * g + self._off_wall(d["food_col"])).long()
        food = torch.zeros((n, g * g), dtype=torch.bool, device=dev).scatter(1, food_idx, True).reshape(n, g, g)
        none = torch.zeros((n, MAX_WALLS), dtype=torch.bool, device=dev)
        return MultiRoomState(
            pos=torch.stack([d["start_row"], torch.zeros_like(d["start_row"])], dim=-1),
            door_row=d["door_row"],
            door_open=none,
            key_taken=none.clone(),
            key_pos=key_pos,
            food=food,
            goal=torch.stack([d["goal_row"], torch.full_like(d["goal_row"], g - 1)], dim=-1),
            t=torch.zeros(n, dtype=torch.int32, device=dev),
            level=torch.full((n,), self.level, dtype=torch.float32, device=dev),
        )

    def observe(self, state: MultiRoomState) -> Obs:
        g, dev = self.grid, state.pos.device
        n = state.pos.shape[0]
        n_walls = self._n_walls(state.level)

        def rgb(name):
            return self.const(name, dev)

        rows = torch.arange(g, device=dev)
        img = torch.zeros((n, g, g, 3), dtype=torch.uint8, device=dev)
        # walls and doors of the active walls; an inactive wall is floor
        for w, c in enumerate(self.wall_cols):
            active = (w < n_walls)[:, None, None]
            is_door = (rows[None, :] == state.door_row[:, w, None])[..., None]
            door = torch.where(state.door_open[:, w, None, None], rgb("open"), rgb("door"))
            col_rgb = torch.where(is_door, door, rgb("wall"))
            img[:, :, c, :] = torch.where(active, col_rgb, img[:, :, c, :])
        # food, then the untaken keys of active walls, then the goal, the agent on top
        img = torch.where(state.food[..., None], rgb("food"), img)
        for w in range(MAX_WALLS):
            kmask = cell_mask(state.key_pos[:, w], g) & ((w < n_walls) & ~state.key_taken[:, w])[:, None, None]
            img = torch.where(kmask[..., None], rgb("key"), img)
        img = torch.where(cell_mask(state.goal, g)[..., None], rgb("goal"), img)
        img = torch.where(cell_mask(state.pos, g)[..., None], rgb("agent"), img)
        return {"rgb": upsample(img, self.cell)}

    def step(self, state: MultiRoomState, action: torch.Tensor):
        g = self.grid
        n_walls = self._n_walls(state.level)
        cand = apply_moves(self.const("moves", state.pos.device), state.pos, action, g)
        # an active wall's cell blocks unless it is that wall's open door
        blocked = torch.zeros_like(state.t, dtype=torch.bool)
        for w, c in enumerate(self.wall_cols):
            passable = (cand[:, 0] == state.door_row[:, w]) & state.door_open[:, w]
            blocked = blocked | ((w < n_walls) & (cand[:, 1] == c) & ~passable)
        pos = torch.where(blocked[:, None], state.pos, cand)

        # a key pickup unlocks its door
        reward = torch.zeros(pos.shape[0], dtype=torch.float32, device=pos.device)
        on_key = ((pos[:, None, :] == state.key_pos).all(dim=-1)
                  & (torch.arange(MAX_WALLS, device=pos.device)[None, :] < n_walls[:, None]) & ~state.key_taken)
        for w in range(MAX_WALLS):
            reward = reward + 0.2 * on_key[:, w].to(torch.float32)
        key_taken = state.key_taken | on_key
        door_open = state.door_open | on_key

        here = cell_mask(pos, g)
        ate = (state.food & here).any(dim=(1, 2))
        food = state.food & ~here
        reward = reward + 0.1 * ate.to(torch.float32)
        at_goal = (pos == state.goal).all(dim=-1)
        reward = reward + at_goal.to(torch.float32)

        t = state.t + 1
        new_state = state._replace(pos=pos, door_open=door_open, key_taken=key_taken, food=food, t=t)
        truncated = (t >= self.max_episode_steps) & ~at_goal
        return new_state, self.observe(new_state), reward, at_goal, truncated
