"""Host replay buffers of the port (numpy only)."""

from sheeprl_tpu_torch.data.buffers import (
    EnvIndependentReplayBuffer,
    EpisodeBuffer,
    ReplayBuffer,
    SequentialReplayBuffer,
)

__all__ = ["EnvIndependentReplayBuffer", "EpisodeBuffer", "ReplayBuffer", "SequentialReplayBuffer"]
