"""Checkpoint serialization, the original import surface (counterpart of
``sheeprl_tpu/utils/checkpoint.py``):

* :func:`save_checkpoint` — a single durable file (``torch.save``);
* :func:`load_checkpoint` — a single file (the port's, or a legacy JAX
  ``.ckpt`` pickle) or a committed step directory (the port's or the JAX
  package's);
* :func:`prune_checkpoints` — retention of the legacy flat ``ckpt_*.ckpt``
  files; snapshot directories are retained by
  :func:`sheeprl_tpu_torch.checkpoint.manager.gc_checkpoints`.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Union

from sheeprl_tpu_torch.checkpoint.protocol import latest_checkpoint  # noqa: F401  (re-export)
from sheeprl_tpu_torch.checkpoint.serialize import load_checkpoint, save_checkpoint  # noqa: F401  (re-exports)


def prune_checkpoints(ckpt_dir: Union[str, os.PathLike], keep_last: Optional[int]) -> None:
    """Delete all but the newest ``keep_last`` legacy flat-file checkpoints
    of a directory."""
    if keep_last is None or keep_last <= 0:
        return
    ckpts = sorted(Path(ckpt_dir).glob("ckpt_*.ckpt"), key=lambda p: p.stat().st_mtime)
    for old in ckpts[:-keep_last]:
        try:
            old.unlink()
        except OSError:
            pass
