"""Flight recorder: a bounded in-memory ring of recent runtime events
(a copy of ``sheeprl_tpu/telemetry/recorder.py``).

A run dies in ways the metric stream cannot explain after the fact: a
fault plan aborts it, an env exhausts its restart budget, a preemption
latch fires mid-update.  The recorder keeps the last ``capacity`` events —
span edges, injected faults, watchdog stalls, env restarts, breaker opens,
compiles (CUDA graph captures), checkpoint saves — and on any abnormal exit
dumps them as a structured ``postmortem.json`` under the run directory,
together with a snapshot of the monitor totals and the current phase
breakdown.  The document has the JAX package's ``SCHEMA`` and keys, so one
supervisor reads either package's dumps.

Recording is append-to-a-deque cheap and never raises; dumping is
best-effort (an atomic tmp+rename write) and never masks the exception
that triggered it.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

#: postmortem.json schema identifier (bump on breaking layout changes)
SCHEMA = "sheeprl.postmortem/1"


class FlightRecorder:
    """Process-global bounded event ring + postmortem dumper."""

    def __init__(self, capacity: int = 2048) -> None:
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=int(capacity))
        self._run_dir: Optional[str] = None
        self._last_dump: Optional[str] = None
        self._last_reason: Optional[str] = None
        self.enabled = True

    # -- configuration -------------------------------------------------------
    def configure(self, cfg: Any = None, run_dir: Optional[str] = None) -> None:
        """Apply the ``telemetry.recorder`` config group and pin the run
        directory the postmortem lands in (called per run from
        ``telemetry.setup_run``)."""
        cfg = cfg or {}
        self.enabled = bool(cfg.get("enabled", True))
        capacity = int(cfg.get("capacity", 2048))
        with self._lock:
            if capacity != self._events.maxlen:
                self._events = deque(self._events, maxlen=capacity)
            if run_dir:
                self._run_dir = str(run_dir)

    @property
    def run_dir(self) -> Optional[str]:
        return self._run_dir

    @property
    def last_dump(self) -> Optional[str]:
        return self._last_dump

    @property
    def last_reason(self) -> Optional[str]:
        """The reason of the last postmortem written since :meth:`clear`."""
        return self._last_reason

    # -- recording -----------------------------------------------------------
    def record(self, kind: str, **fields: Any) -> None:
        """Append one event.  Hot-path-safe: one enabled test, one dict
        build, one locked deque append; never raises."""
        if not self.enabled:
            return
        evt: Dict[str, Any] = {"t": round(time.time(), 6), "kind": str(kind)}
        evt.update(fields)
        try:
            with self._lock:
                self._events.append(evt)
        except Exception:
            pass

    def snapshot(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        """The newest ``n`` events (all, when ``n`` is None), oldest first."""
        with self._lock:
            events = list(self._events)
        return events[-int(n):] if n else events

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
        self._last_dump = None
        self._last_reason = None

    # -- postmortem ----------------------------------------------------------
    def document(self, reason: str) -> Dict[str, Any]:
        """The postmortem document (also served by ``/v1/recorder``)."""
        # lazy imports: the recorder is imported by the monitors — pulling
        # them in at module level would be a cycle
        doc: Dict[str, Any] = {
            "schema": SCHEMA,
            "reason": str(reason),
            "written_at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "pid": os.getpid(),
            "run_dir": self._run_dir,
            "events": self.snapshot(),
        }
        try:
            # the newest policy step the hub flushed at: a supervisor's
            # failure classifier keys its fatal signature on (error, step) —
            # the same crash at the same step twice is deterministic
            from sheeprl_tpu_torch.telemetry.hub import HUB

            doc["last_step"] = int(HUB.last_step)
        except Exception:
            doc["last_step"] = None
        try:
            from sheeprl_tpu_torch.telemetry.monitors import (
                CHECKPOINT_MONITOR,
                COMPILE_MONITOR,
                RESILIENCE_MONITOR,
            )

            n_exe, compile_s = COMPILE_MONITOR.totals()
            doc["monitors"] = {
                "compile": {"executables": n_exe, "compile_time_s": round(compile_s, 3)},
                "checkpoint": CHECKPOINT_MONITOR.totals(),
                "resilience": RESILIENCE_MONITOR.totals(),
            }
        except Exception:
            doc["monitors"] = None
        try:
            from sheeprl_tpu_torch.telemetry.spans import SPANS

            doc["phase_breakdown"] = SPANS.breakdown()
        except Exception:
            doc["phase_breakdown"] = None
        return doc

    def dump(self, reason: str, path: Optional[str] = None) -> Optional[str]:
        """Write ``postmortem.json`` (atomic tmp+rename) and return its path.

        Target: ``path`` when given, else ``<run_dir>/postmortem.json``.
        With neither, nothing is written (a crash before the run directory
        exists — e.g. a config error — must not litter the cwd).  Never
        raises: the dump rides exception paths."""
        try:
            if path is None:
                if not self._run_dir:
                    return None
                path = os.path.join(self._run_dir, "postmortem.json")
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(self.document(reason), f, indent=1, default=str)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            self._last_dump, self._last_reason = path, str(reason)
            return path
        except Exception:
            return None


#: The process-global flight recorder every subsystem reports events into.
RECORDER = FlightRecorder()
