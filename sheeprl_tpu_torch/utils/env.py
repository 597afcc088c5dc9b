"""Environment factory for the port: ``make_env`` for the dummy envs.

Counterpart of ``sheeprl_tpu/utils/env.py`` restricted to the ``dummy``
wrapper kind: the suite env, then ActionRepeat, FrameStack and TimeLimit,
seeded like the JAX factory.  Settings this factory does not implement
raise instead of being dropped.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from sheeprl_tpu_torch.envs.dummy import (
    ContinuousDummyEnv,
    DiscreteDummyEnv,
    Env,
    MultiDiscreteDummyEnv,
    PixelGridDummyEnv,
)
from sheeprl_tpu_torch.envs.wrappers import ActionRepeat, FrameStack, RestartOnException, TimeLimit

DUMMY_ENVS = {
    "discrete_dummy": DiscreteDummyEnv,
    "multidiscrete_dummy": MultiDiscreteDummyEnv,
    "continuous_dummy": ContinuousDummyEnv,
    "pixel_grid_dummy": PixelGridDummyEnv,
}


def _unsupported(cfg: Any, run_name: Optional[str]) -> list:
    env = cfg.env
    out = []
    if env.get("mask_velocities", False):
        out.append("env.mask_velocities")
    aao = env.get("actions_as_observation") or {}
    if aao.get("num_stack", -1) > 0:
        out.append("env.actions_as_observation")
    if env.get("reward_as_observation", False):
        out.append("env.reward_as_observation")
    if env.get("clip_rewards", False):
        out.append("env.clip_rewards")
    if env.get("grayscale", False):
        out.append("env.grayscale")
    if env.get("capture_video", False) and run_name is not None:
        out.append("env.capture_video")
    return out


def make_env(
    cfg: Any,
    seed: Optional[int],
    rank: int = 0,
    run_name: Optional[str] = None,
    prefix: str = "",
    vector_env_idx: int = 0,
) -> Callable[[], Env]:
    """Build a thunk creating one wrapped dummy environment instance."""
    env_id = cfg.env.id
    if env_id not in DUMMY_ENVS:
        raise NotImplementedError(
            f"sheeprl_tpu_torch.make_env builds the dummy envs only ({sorted(DUMMY_ENVS)}), not '{env_id}'"
        )
    unsupported = _unsupported(cfg, run_name)
    if unsupported:
        raise NotImplementedError(f"sheeprl_tpu_torch.make_env does not implement {unsupported} yet")

    def _build() -> Env:
        wrapper_cfg = cfg.env.get("wrapper") or {}
        kwargs = {k: v for k, v in dict(wrapper_cfg).items() if k not in ("kind", "id")}
        env: Env = DUMMY_ENVS[env_id](**kwargs)
        if cfg.env.action_repeat > 1:
            env = ActionRepeat(env, cfg.env.action_repeat)
        cnn_keys = [k for k, sp in env.observation_space.spaces.items() if len(sp.shape) in (2, 3)]
        for k in cnn_keys:
            shape = env.observation_space[k].shape
            if shape[:2] != (cfg.env.screen_size, cfg.env.screen_size):
                raise NotImplementedError(
                    f"sheeprl_tpu_torch.make_env does not resize images ({k} is {shape}, "
                    f"env.screen_size={cfg.env.screen_size})"
                )
        if cfg.env.frame_stack > 1 and cnn_keys:
            env = FrameStack(env, cfg.env.frame_stack, cnn_keys, cfg.env.frame_stack_dilation)
        if cfg.env.max_episode_steps is not None and cfg.env.max_episode_steps > 0:
            env = TimeLimit(env, cfg.env.max_episode_steps)
        if seed is not None:
            env.reset(seed=seed + rank * cfg.env.num_envs + vector_env_idx)
            env.action_space.seed(seed + rank * cfg.env.num_envs + vector_env_idx)
        return env

    def thunk() -> Env:
        if cfg.env.get("restart_on_exception", False):
            return RestartOnException(_build)
        return _build()

    return thunk
