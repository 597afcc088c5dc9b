"""Environment factory for the port: ``make_env`` and a synchronous vector
env (counterpart of ``sheeprl_tpu/utils/env.py``).

``make_env`` builds the suite env, then the wrapper pipeline of the JAX
factory in its order: ActionRepeat → velocity masking → a Dict observation
space → image resize / grayscale → FrameStack → actions as observation →
reward as observation → reward clipping → TimeLimit; then seeds it.  The
suites: the dummy envs; the device envs (``wrapper.kind: jax``) behind
:class:`~sheeprl_tpu_torch.envs.device.adapter.DeviceEnvAdapter` on the run's
device; gymnasium (``kind: gym``) and DeepMind Control (``kind: dmc``), whose
packages are imported only when such an env is built.  Settings and suites
not ported yet raise, naming their ROADMAP item.  :func:`vectorize` steps the
envs on the caller's thread with same-step autoreset and episode statistics,
the semantics the JAX loops get from gymnasium's vector envs.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.dummy import (
    ContinuousDummyEnv,
    DiscreteDummyEnv,
    Env,
    MultiDiscreteDummyEnv,
    PixelGridDummyEnv,
)
from sheeprl_tpu_torch.envs.wrappers import (
    ActionRepeat,
    ActionsAsObservationWrapper,
    FaultInjectionEnv,
    FrameStack,
    MaskVelocityWrapper,
    RestartOnException,
    RewardAsObservationWrapper,
    TimeLimit,
    TransformReward,
    Wrapper,
)
from sheeprl_tpu_torch.resilience.faults import active_plan

DUMMY_ENVS = {
    "discrete_dummy": DiscreteDummyEnv,
    "multidiscrete_dummy": MultiDiscreteDummyEnv,
    "continuous_dummy": ContinuousDummyEnv,
    "pixel_grid_dummy": PixelGridDummyEnv,
}
#: the suites whose packages neither the port's CPU host nor its H100 host has
UNPORTED_SUITES = {
    "atari": "ale_py",
    "crafter": "crafter",
    "minedojo": "minedojo",
    "minerl": "minerl",
    "diambra": "diambra",
    "super_mario_bros": "gym_super_mario_bros",
}


def _unsupported(cfg: Any, run_name: Optional[str]) -> list:
    out = []
    if cfg.env.get("capture_video", False) and run_name is not None:
        out.append("env.capture_video (ROADMAP.md, queue A item 6)")
    return out


def _wrapper_config(cfg: Any) -> Dict[str, Any]:
    """``cfg.env.wrapper`` (a dict, a bare suite name or the "???"
    placeholder) as a dict with a ``kind`` entry."""
    wrapper_cfg = cfg.env.get("wrapper") or {}
    if not isinstance(wrapper_cfg, dict):
        wrapper_cfg = {"kind": str(wrapper_cfg)} if wrapper_cfg != "???" else {}
    return {"kind": "gym", **wrapper_cfg}


def _make_base_env(cfg: Any, seed: Optional[int], render_mode: str) -> Env:
    env_id = cfg.env.id
    wrapper_cfg = _wrapper_config(cfg)
    kind = wrapper_cfg["kind"]
    kwargs = {k: v for k, v in wrapper_cfg.items() if k not in ("kind", "id")}
    if env_id in DUMMY_ENVS:
        return DUMMY_ENVS[env_id](**kwargs)
    if kind == "jax":
        from sheeprl_tpu_torch.envs.device.adapter import DeviceEnvAdapter
        from sheeprl_tpu_torch.envs.device.registry import env_kwargs, make_device_env
        from sheeprl_tpu_torch.fabric import run_device

        env = make_device_env(wrapper_cfg.get("id") or env_id, **env_kwargs(cfg))
        return DeviceEnvAdapter(env, run_device(cfg))
    if kind == "gym":
        from sheeprl_tpu_torch.envs.gymnasium_env import GymnasiumEnv

        return GymnasiumEnv(env_id, render_mode=render_mode, **kwargs)
    if kind == "dmc":
        from sheeprl_tpu_torch.envs.dmc import DMCWrapper

        return DMCWrapper(env_id, seed=seed, **kwargs)
    if kind in UNPORTED_SUITES:
        raise NotImplementedError(
            f"env.wrapper.kind={kind} is not ported: its package ({UNPORTED_SUITES[kind]}) is on neither machine "
            "the port runs on (ROADMAP.md, queue A item 2)"
        )
    raise ValueError(f"Unknown env wrapper kind '{kind}'")


class _DictObs(Wrapper):
    """Any observation space as a Dict: vectors under 'state', images under 'rgb'."""

    def __init__(self, env: Env):
        super().__init__(env)
        obs_space = env.observation_space
        if isinstance(obs_space, spaces.Dict):
            self._key = None
        else:
            self._key = "rgb" if len(obs_space.shape or ()) == 3 else "state"
            self.observation_space = spaces.Dict({self._key: obs_space})

    def _observation(self, obs: Any) -> Dict[str, Any]:
        return obs if self._key is None else {self._key: obs}

    def reset(self, **kwargs: Any):
        obs, info = self.env.reset(**kwargs)
        return self._observation(obs), info

    def step(self, action: Any):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return self._observation(obs), reward, terminated, truncated, info


class _ImageTransform(Wrapper):
    """Every image key as ``(screen, screen, C)`` uint8: resized with
    ``cv2.INTER_AREA``, turned gray (``COLOR_RGB2GRAY``) or given three
    channels as ``grayscale`` asks, CHW frames turned HWC."""

    def __init__(self, env: Env, cnn_keys: List[str], screen_size: int, grayscale: bool):
        super().__init__(env)
        import cv2

        self._cv2 = cv2
        self._cnn_keys = cnn_keys
        self._screen = screen_size
        self._gray = grayscale
        new_spaces = dict(env.observation_space.spaces)
        for k in cnn_keys:
            new_spaces[k] = spaces.Box(0, 255, (screen_size, screen_size, 1 if grayscale else 3), np.uint8)
        self.observation_space = spaces.Dict(new_spaces)

    def _transform(self, img: np.ndarray) -> np.ndarray:
        cv2 = self._cv2
        img = np.asarray(img)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[0] in (1, 3) and img.shape[-1] not in (1, 3):
            img = np.transpose(img, (1, 2, 0))
        if img.shape[:2] != (self._screen, self._screen):
            img = cv2.resize(img, (self._screen, self._screen), interpolation=cv2.INTER_AREA)
            if img.ndim == 2:
                img = img[..., None]
        if self._gray and img.shape[-1] == 3:
            img = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)[..., None]
        elif not self._gray and img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        return img.astype(np.uint8)

    def _observation(self, obs: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(obs)
        for k in self._cnn_keys:
            out[k] = self._transform(obs[k])
        return out

    def reset(self, **kwargs: Any):
        obs, info = self.env.reset(**kwargs)
        return self._observation(obs), info

    def step(self, action: Any):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return self._observation(obs), reward, terminated, truncated, info


def make_env(
    cfg: Any,
    seed: Optional[int],
    rank: int = 0,
    run_name: Optional[str] = None,
    prefix: str = "",
    vector_env_idx: int = 0,
) -> Callable[[], Env]:
    """Build a thunk creating one wrapped environment instance; a device env
    steps on the run's device (``fabric.accelerator``)."""
    unsupported = _unsupported(cfg, run_name)
    if unsupported:
        raise NotImplementedError(f"sheeprl_tpu_torch.make_env does not implement {unsupported} yet")

    def _build() -> Env:
        render_mode = cfg.env.get("render_mode", "rgb_array")
        env = _make_base_env(cfg, seed, render_mode)
        if cfg.env.action_repeat > 1:
            env = ActionRepeat(env, cfg.env.action_repeat)
        if cfg.env.get("mask_velocities", False):
            # keyed on gymnasium ids: any other env raises, as in the JAX factory
            env = MaskVelocityWrapper(env, cfg.env.id if _wrapper_config(cfg)["kind"] == "gym" else "")
        env = _DictObs(env)
        cnn_keys = [k for k, sp in env.observation_space.spaces.items() if len(sp.shape) in (2, 3)]
        if cnn_keys:
            env = _ImageTransform(env, cnn_keys, cfg.env.screen_size, cfg.env.grayscale)
        if cfg.env.frame_stack > 1 and cnn_keys:
            env = FrameStack(env, cfg.env.frame_stack, cnn_keys, cfg.env.frame_stack_dilation)
        aao = cfg.env.get("actions_as_observation") or {}
        if aao.get("num_stack", -1) > 0:
            env = ActionsAsObservationWrapper(env, aao["num_stack"], aao["noop"], aao.get("dilation", 1))
        if cfg.env.get("reward_as_observation", False):
            env = RewardAsObservationWrapper(env)
        if cfg.env.get("clip_rewards", False):
            env = TransformReward(env, lambda r: float(np.tanh(r)))
        if cfg.env.max_episode_steps is not None and cfg.env.max_episode_steps > 0:
            env = TimeLimit(env, cfg.env.max_episode_steps)
        if seed is not None:
            env.reset(seed=seed + rank * cfg.env.num_envs + vector_env_idx)
            env.action_space.seed(seed + rank * cfg.env.num_envs + vector_env_idx)
        # the env fault sites, only when the active plan targets them; after
        # seeding (a construction reset is no target) and inside
        # RestartOnException, so an injected crash takes the real restart path
        plan = active_plan()
        if plan is not None and plan.targets("env."):
            env = FaultInjectionEnv(env)
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
