"""The compile and resilience monitors (counterpart of
``sheeprl_tpu/telemetry/monitors.py``).

:class:`CompileMonitor` counts the programs built for each compile-once
function of the port — on the card one captured CUDA graph per signature,
on the CPU one eager entry per signature (``parallel/compile.py``) — and
keeps each one's signature.  :class:`ResilienceMonitor` counts what the
resilience layer (``resilience/``) did: retries, watchdog stalls, breaker
openings, quarantined snapshots and injected faults; the train loops flush
its ``Resilience/*`` metrics with their own.  The JAX module also registers
its monitors with the telemetry hub and writes events to the flight
recorder; neither exists in the port yet (ROADMAP.md, queue A item 6(b)),
so this copy keeps the accounting alone.
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


class ResilienceMonitor:
    """Process-global accounting of the resilience layer: primitives record
    from any thread, :meth:`metrics` gives the ``Resilience/*`` counters.
    When nothing has been recorded it returns ``{}``, so a run with no
    fault plan and no recovery logs no ``Resilience/*`` metric."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._counts = {k: 0 for k in _RESILIENCE_METRICS}
            self._injected_by_site: Dict[str, int] = {}

    def _add(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counts[key] += int(n)

    def record_retry(self, site: str = "") -> None:
        self._add("retries")

    def record_retry_success(self, site: str = "") -> None:
        self._add("retry_successes")

    def record_giveup(self, site: str = "") -> None:
        self._add("giveups")

    def record_stall(self, name: str = "") -> None:
        self._add("stalls")

    def record_env_restart(self, count: int = 1) -> None:
        self._add("env_restarts", count)

    def record_breaker(self, name: str, state: str) -> None:
        if state == "open":
            self._add("breaker_opens")

    def record_quarantine(self, path: Any = None) -> None:
        self._add("quarantined")

    def record_injection(self, site: str, kind: str) -> None:
        with self._lock:
            self._counts["injected"] += 1
            self._injected_by_site[site] = self._injected_by_site.get(site, 0) + 1

    def metrics(self) -> Dict[str, float]:
        with self._lock:
            return {name: float(self._counts[k]) for k, name in _RESILIENCE_METRICS.items() if self._counts[k]}

    def totals(self) -> Dict[str, Any]:
        with self._lock:
            return {**self._counts, "injected_by_site": dict(self._injected_by_site)}


_RESILIENCE_METRICS = {
    "retries": "Resilience/retries",
    "retry_successes": "Resilience/retry_successes",
    "giveups": "Resilience/giveups",
    "stalls": "Resilience/watchdog_stalls",
    "env_restarts": "Resilience/env_restarts",
    "breaker_opens": "Resilience/breaker_opens",
    "quarantined": "Resilience/quarantined_snapshots",
    "injected": "Resilience/faults_injected",
}

#: The process-global monitor every resilience primitive reports into.
RESILIENCE_MONITOR = ResilienceMonitor()
