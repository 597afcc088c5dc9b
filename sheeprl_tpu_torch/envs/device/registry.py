"""Registry and config plumbing of the device envs (counterpart of
``sheeprl_tpu/envs/jax/registry.py``).

The ``env=jax_*`` config groups set ``env.wrapper.kind: jax`` and a registry
``id``; :func:`env_from_cfg` builds the env from there.  Two consumers: the
host loops, through :class:`~sheeprl_tpu_torch.envs.device.adapter.DeviceEnvAdapter`
in ``utils/env.py::make_env``, and the Anakin rollout of the on-policy loops,
which :func:`anakin_enabled` selects.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from sheeprl_tpu_torch.envs.device.core import DeviceEnv, VectorDeviceEnv


def _cartpole(**kwargs: Any) -> DeviceEnv:
    from sheeprl_tpu_torch.envs.device.cartpole import CartPole

    return CartPole(**kwargs)


def _pendulum(**kwargs: Any) -> DeviceEnv:
    from sheeprl_tpu_torch.envs.device.pendulum import Pendulum

    return Pendulum(**kwargs)


def _forage(**kwargs: Any) -> DeviceEnv:
    from sheeprl_tpu_torch.envs.device.forage import Forage

    return Forage(**kwargs)


def _multiroom(**kwargs: Any) -> DeviceEnv:
    from sheeprl_tpu_torch.envs.device.multiroom import MultiRoom

    return MultiRoom(**kwargs)


DEVICE_ENVS: Dict[str, Callable[..., DeviceEnv]] = {
    "cartpole": _cartpole,
    "pendulum": _pendulum,
    "forage": _forage,
    "multiroom": _multiroom,
}


def make_device_env(env_id: str, **kwargs: Any) -> DeviceEnv:
    """A registered device env; takes the bare name (``cartpole``) or the
    config group's spelling (``jax_cartpole``)."""
    name = env_id[4:] if env_id.startswith("jax_") else env_id
    if name not in DEVICE_ENVS:
        raise ValueError(f"Unknown device env '{env_id}'; options: {sorted(DEVICE_ENVS)}")
    return DEVICE_ENVS[name](**kwargs)


def is_native(cfg: Any) -> bool:
    """Whether the selected env group is a device env (``wrapper.kind: jax``)."""
    wrapper = cfg.env.get("wrapper") or {}
    return isinstance(wrapper, dict) and wrapper.get("kind") == "jax"


def env_kwargs(cfg: Any) -> Dict[str, Any]:
    """The constructor arguments of the configured device env: the wrapper's
    own, with a top-level ``env.level`` reaching every env."""
    kwargs = {k: v for k, v in dict(cfg.env.get("wrapper") or {}).items() if k not in ("kind", "id")}
    if cfg.env.get("level") is not None:
        kwargs.setdefault("level", float(cfg.env.level))
    return kwargs


def env_from_cfg(cfg: Any) -> DeviceEnv:
    """The configured device env, ``env.max_episode_steps`` overriding its limit."""
    env_id = (cfg.env.get("wrapper") or {}).get("id") or cfg.env.id
    env = make_device_env(env_id, **env_kwargs(cfg))
    if cfg.env.get("max_episode_steps"):
        env.max_episode_steps = int(cfg.env.max_episode_steps)
    return env


def vector_env_from_cfg(cfg: Any, device: Any) -> VectorDeviceEnv:
    """``env.num_envs`` of the configured device env on ``device``, their
    resets drawn from a generator seeded from ``cfg.seed`` (the Anakin
    rollout's envs)."""
    generator = torch.Generator(device).manual_seed(int(cfg.seed) + 2)
    return VectorDeviceEnv(env_from_cfg(cfg), int(cfg.env.num_envs), device, generator)


def unapplied_settings(cfg: Any, env: DeviceEnv) -> List[str]:
    """The ``env.*`` wrapper settings of ``cfg`` that would change ``env``
    under ``make_env`` and that the Anakin rollout does not apply."""
    out = []
    if cfg.env.get("action_repeat", 1) > 1:
        out.append("env.action_repeat")
    if cfg.env.get("mask_velocities", False):
        out.append("env.mask_velocities")
    images = [sp.shape for sp in env.observation_space.spaces.values() if len(sp.shape) in (2, 3)]
    if images:
        if cfg.env.get("frame_stack", 1) > 1:
            out.append("env.frame_stack")
        if any(shape[:2] != (cfg.env.screen_size, cfg.env.screen_size) for shape in images):
            out.append("env.screen_size")
        if cfg.env.get("grayscale", False):
            out.append("env.grayscale")
    if (cfg.env.get("actions_as_observation") or {}).get("num_stack", -1) > 0:
        out.append("env.actions_as_observation")
    if cfg.env.get("reward_as_observation", False):
        out.append("env.reward_as_observation")
    if cfg.env.get("clip_rewards", False):
        out.append("env.clip_rewards")
    return out


def anakin_enabled(cfg: Any) -> bool:
    """Whether an on-policy loop runs the Anakin rollout.

    ``algo.anakin``: ``auto`` (the default) whenever the env is a device env;
    ``True`` demands it, raising on any other env; ``False`` runs the host
    loop through the adapter even on a device env.  (The JAX package also
    falls back to the adapter on a multi-process run; the port runs one
    process.)  The rollout steps the bare env, so a wrapper setting that
    would change it raises here, where the JAX package ignores it."""
    mode = cfg.algo.get("anakin", "auto")
    native = is_native(cfg)
    if isinstance(mode, str) and mode.lower() == "auto":
        enabled = native
    elif bool(mode):
        if not native:
            raise ValueError(f"algo.anakin=True requires a device env (env=jax_*); got env.id={cfg.env.id!r}")
        enabled = True
    else:
        enabled = False
    unapplied = unapplied_settings(cfg, env_from_cfg(cfg)) if enabled else []
    if unapplied:
        raise NotImplementedError(
            f"the Anakin rollout steps the bare device env and does not apply {unapplied}; "
            "leave them at their defaults"
        )
    return enabled
