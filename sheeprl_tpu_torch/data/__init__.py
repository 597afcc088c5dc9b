"""Replay of the port: the host buffers (numpy) and the device-resident ring."""

from sheeprl_tpu_torch.data.buffers import (
    EnvIndependentReplayBuffer,
    EpisodeBuffer,
    ReplayBuffer,
    SequentialReplayBuffer,
)
from sheeprl_tpu_torch.data.device_replay import (
    DeviceReplay,
    HostSpill,
    build_device_replay,
    draw_sequence,
    draw_uniform,
    estimate_step_bytes,
    fit_hbm_window,
    fused_sequence_train,
    fused_uniform_train,
    resolve_device_replay,
    stage,
    stage_rollout,
    stage_scalar,
    steady_guard,
    update_chunks,
)

__all__ = [
    "DeviceReplay",
    "EnvIndependentReplayBuffer",
    "EpisodeBuffer",
    "HostSpill",
    "ReplayBuffer",
    "build_device_replay",
    "SequentialReplayBuffer",
    "draw_sequence",
    "draw_uniform",
    "estimate_step_bytes",
    "fit_hbm_window",
    "fused_sequence_train",
    "fused_uniform_train",
    "resolve_device_replay",
    "stage",
    "stage_rollout",
    "stage_scalar",
    "steady_guard",
    "update_chunks",
]
