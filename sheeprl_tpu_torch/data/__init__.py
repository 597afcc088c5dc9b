"""Host replay buffers of the port (numpy only)."""

from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, ReplayBuffer, SequentialReplayBuffer

__all__ = ["EnvIndependentReplayBuffer", "ReplayBuffer", "SequentialReplayBuffer"]
