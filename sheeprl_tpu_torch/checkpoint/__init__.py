"""Snapshot commit protocol of the port (``torch.save`` shards)."""

from sheeprl_tpu_torch.checkpoint.protocol import (
    checkpoint_step,
    is_committed,
    latest_checkpoint,
    list_checkpoints,
    load_step_dir,
    verify_checkpoint,
    verify_or_quarantine,
    write_snapshot,
)

__all__ = [
    "checkpoint_step",
    "is_committed",
    "latest_checkpoint",
    "list_checkpoints",
    "load_step_dir",
    "verify_checkpoint",
    "verify_or_quarantine",
    "write_snapshot",
]
