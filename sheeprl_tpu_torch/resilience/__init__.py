"""Training-health sentinels of the port."""

from sheeprl_tpu_torch.resilience.health import HealthSentinel

__all__ = ["HealthSentinel"]
