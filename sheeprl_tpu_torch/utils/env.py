"""Environment factory for the port: ``make_env`` for the dummy envs and a
synchronous vector env.

Counterpart of ``sheeprl_tpu/utils/env.py`` restricted to the ``dummy``
wrapper kind: the suite env, then ActionRepeat, FrameStack and TimeLimit,
seeded like the JAX factory.  Settings this factory does not implement
raise instead of being dropped.  :func:`vectorize` steps the envs on the
caller's thread with same-step autoreset and episode statistics, the
semantics the JAX loops get from gymnasium's vector envs.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

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


class SyncVectorEnv:
    """``n`` envs stepped in turn on the caller's thread.

    Same-step autoreset: an env whose episode ends is reset within the same
    ``step``; the returned observation is the reset's, the final one is in
    ``info["final_obs"]`` (an object array, None for running envs).  Finished
    episodes report their return and length in ``info["episode"]`` under
    the mask ``info["_episode"]``; other per-env info keys become arrays
    under ``info[key]`` with the mask ``info["_" + key]``."""

    def __init__(self, thunks: List[Callable[[], Env]]):
        self.envs = [t() for t in thunks]
        self.num_envs = len(self.envs)
        self.single_observation_space = self.envs[0].observation_space
        self.single_action_space = self.envs[0].action_space
        self._returns = np.zeros(self.num_envs, np.float64)
        self._lengths = np.zeros(self.num_envs, np.int64)

    @staticmethod
    def _stack(obs: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        return {k: np.stack([np.asarray(o[k]) for o in obs]) for k in obs[0]}

    @staticmethod
    def _merge_infos(infos: List[Dict[str, Any]], into: Dict[str, Any]) -> Dict[str, Any]:
        n = len(infos)
        for i, info in enumerate(infos):
            for k, v in info.items():
                if k not in into:
                    into[k] = np.zeros(n, dtype=np.asarray(v).dtype) if np.isscalar(v) else np.empty(n, object)
                    into["_" + k] = np.zeros(n, bool)
                into[k][i] = v
                into["_" + k][i] = True
        return into

    def reset(self, seed: Optional[int] = None) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        results = [env.reset(seed=None if seed is None else seed + i) for i, env in enumerate(self.envs)]
        self._returns[:] = 0.0
        self._lengths[:] = 0
        return self._stack([o for o, _ in results]), self._merge_infos([i for _, i in results], {})

    def step(self, actions: np.ndarray):
        obs, infos = [], []
        rewards = np.zeros(self.num_envs, np.float64)
        terminated = np.zeros(self.num_envs, bool)
        truncated = np.zeros(self.num_envs, bool)
        final_obs = np.empty(self.num_envs, object)
        ep_r = np.zeros(self.num_envs, np.float64)
        ep_l = np.zeros(self.num_envs, np.int64)
        done_mask = np.zeros(self.num_envs, bool)
        for i, env in enumerate(self.envs):
            o, r, term, trunc, info = env.step(actions[i])
            rewards[i], terminated[i], truncated[i] = float(r), bool(term), bool(trunc)
            self._returns[i] += float(r)
            self._lengths[i] += 1
            if term or trunc:
                final_obs[i] = o
                ep_r[i], ep_l[i], done_mask[i] = self._returns[i], self._lengths[i], True
                self._returns[i], self._lengths[i] = 0.0, 0
                o, reset_info = env.reset()
                info = {**info, **reset_info}
            obs.append(o)
            infos.append(info)
        out_info = self._merge_infos(infos, {})
        if done_mask.any():
            out_info["final_obs"], out_info["_final_obs"] = final_obs, done_mask
            out_info["episode"], out_info["_episode"] = {"r": ep_r, "l": ep_l}, done_mask
        return self._stack(obs), rewards, terminated, truncated, out_info

    def close(self) -> None:
        for env in self.envs:
            env.close()


def vectorize(cfg: Any, thunks: List[Callable[[], Env]]) -> SyncVectorEnv:
    """The envs of ``thunks`` behind one :class:`SyncVectorEnv` (the port has
    no subprocess vector env; ``env.sync_env=False`` steps synchronously too)."""
    return SyncVectorEnv(thunks)


def episode_stats(info: Dict[str, Any]) -> List[Tuple[float, int]]:
    """Finished-episode (return, length) pairs of one vector step."""
    if "episode" not in info:
        return []
    ep, mask = info["episode"], np.asarray(info["_episode"], bool)
    return [(float(ep["r"][i]), int(ep["l"][i])) for i in np.nonzero(mask)[0]]


def final_obs_rows(info: Dict[str, Any], env_indices: np.ndarray, obs_keys) -> Optional[Dict[str, np.ndarray]]:
    """The real final observations of the given env rows, stacked per key
    (None when any of them is missing)."""
    fo = info.get("final_obs")
    if fo is None:
        return None
    rows = [fo[i] for i in env_indices]
    if any(not isinstance(r, dict) for r in rows):
        return None
    return {k: np.stack([np.asarray(r[k]) for r in rows]) for k in obs_keys}
