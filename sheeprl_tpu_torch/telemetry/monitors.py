"""The compile monitor (counterpart of ``sheeprl_tpu/telemetry/monitors.py``).

:class:`CompileMonitor` counts the programs built for each compile-once
function of the port — on the card one captured CUDA graph per signature,
on the CPU one eager entry per signature (``parallel/compile.py``) — and
keeps each one's signature.  The JAX module also registers its monitors
with the telemetry hub and writes compiles to the flight recorder; neither
exists in the port yet (ROADMAP.md, queue A item 6), so this copy keeps the
accounting alone.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional


class RecompileLimitExceeded(RuntimeError):
    """A compile-once function exceeded its allowed recompile budget."""


class CompileMonitor:
    """Process-global per-function build counter + signature log.

    ``count(name)`` is the number of programs built for ``name`` — the first
    build is expected; every further one is a *recompile* caused by a new
    signature.  The ``max_recompiles`` budget itself is enforced per
    :class:`~sheeprl_tpu_torch.parallel.compile.GraphFunction` instance,
    which raises :class:`RecompileLimitExceeded`; this monitor is the
    process-wide aggregate view.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._stats: Dict[str, Dict[str, Any]] = {}

    def begin(self, name: str, signature: Any) -> None:
        """Count one build of ``name`` (bookkeeping only: the budget is the
        instance's, see ``GraphFunction``)."""
        with self._lock:
            st = self._stats.setdefault(name, {"count": 0, "seconds": 0.0, "signatures": []})
            st["count"] += 1
            st["signatures"].append(str(signature))

    def abort(self, name: str, signature: Any = None) -> None:
        """Roll back one ``begin`` for ``name``: the build failed, so no
        program exists.  With ``signature`` the matching history entry
        (searched from the end) is removed, else the last one."""
        with self._lock:
            st = self._stats.get(name)
            if st is None or st["count"] <= 0:
                return
            st["count"] -= 1
            if not st["signatures"]:
                return
            if signature is None:
                st["signatures"].pop()
                return
            sig_str = str(signature)
            for i in range(len(st["signatures"]) - 1, -1, -1):
                if st["signatures"][i] == sig_str:
                    del st["signatures"][i]
                    break

    def end(self, name: str, seconds: float) -> None:
        with self._lock:
            st = self._stats.get(name)
            if st is not None:
                st["seconds"] += float(seconds)

    @staticmethod
    def default_limit() -> Optional[int]:
        raw = os.environ.get("SHEEPRL_MAX_RECOMPILES", "").strip()
        return int(raw) if raw else None

    def count(self, name: str) -> int:
        with self._lock:
            return int(self._stats.get(name, {}).get("count", 0))


#: The process-global monitor every GraphFunction reports into.
COMPILE_MONITOR = CompileMonitor()
