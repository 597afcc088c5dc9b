"""Batched environments on the device and the Anakin rollout (the port's
counterpart of ``sheeprl_tpu/envs/jax/``): CartPole, Pendulum, Forage and
MultiRoom stepped as tensors on the run's device."""

from sheeprl_tpu_torch.envs.device.core import DeviceEnv, VectorDeviceEnv
from sheeprl_tpu_torch.envs.device.registry import (
    DEVICE_ENVS,
    anakin_enabled,
    env_from_cfg,
    is_native,
    make_device_env,
    vector_env_from_cfg,
)

__all__ = ["DEVICE_ENVS", "DeviceEnv", "VectorDeviceEnv", "anakin_enabled", "env_from_cfg", "is_native",
           "make_device_env",
           "vector_env_from_cfg"]
