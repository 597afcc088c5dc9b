"""Config composition (a copy of the JAX package's engine, same syntax)."""

from sheeprl_tpu_torch.config.compose import ConfigError, apply_cli_overrides, compose

__all__ = ["ConfigError", "apply_cli_overrides", "compose"]
