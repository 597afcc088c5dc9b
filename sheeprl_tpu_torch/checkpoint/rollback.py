"""Rollback to the newest committed snapshot of this run (counterpart of
``sheeprl_tpu/checkpoint/rollback.py``): what the health guard restores
when ``health.divergence.action=rollback`` and the divergence detector has
fired.

The newest committed snapshot of the current run is verified against its
CRCs before it is trusted; a damaged one is quarantined, as on resume, and
the next newest is tried.  Only this run's checkpoint root is searched: a
rollback never jumps to another run's weights.  With no committed snapshot
the caller raises :class:`~sheeprl_tpu_torch.resilience.health.DivergenceError`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Optional, Tuple

from sheeprl_tpu_torch.checkpoint.protocol import verify_or_quarantine


def rollback_state(ckpt_mgr: Any, fabric: Any) -> Tuple[Optional[dict], Optional[Path]]:
    """``(state, step_dir)`` of the newest intact committed snapshot of this
    run, or ``(None, None)`` when there is none.  The writer is drained
    first, so a save already queued (usually the last cadence save before the
    divergence) counts."""
    ckpt_mgr.flush()
    target = ckpt_mgr.latest()
    while target is not None and verify_or_quarantine(target):
        # quarantined (renamed step_*.corrupt), or not renameable on a
        # read-only store: then latest() returns it again, so stop
        nxt = ckpt_mgr.latest()
        target = None if nxt == target else nxt
    if target is None:
        return None, None
    return fabric.load(target), target
