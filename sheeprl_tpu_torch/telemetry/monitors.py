"""The compile, checkpoint and resilience monitors (counterpart of
``sheeprl_tpu/telemetry/monitors.py``), owned by the telemetry hub.

:class:`CompileMonitor` counts the programs built for each compile-once
function of the port — on the card one captured CUDA graph per signature,
on the CPU one eager entry per signature (``parallel/compile.py``) — and
keeps each one's signature.  :class:`CheckpointMonitor` counts the
checkpoint writer's saves, bytes, errors and queue depth.
:class:`ResilienceMonitor` counts what the resilience layer
(``resilience/``) did: retries, watchdog stalls, env restarts, breaker
openings, quarantined snapshots and injected faults.  All three register
with :data:`~sheeprl_tpu_torch.telemetry.hub.HUB` at import, so every
metric flush carries ``Compile/*``, ``Checkpoint/*`` and ``Resilience/*``,
and their notable transitions (builds, saves, stalls, breaker openings,
quarantines, injections) land in the flight recorder.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Tuple

from sheeprl_tpu_torch.telemetry.hub import HUB
from sheeprl_tpu_torch.telemetry.recorder import RECORDER


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
        RECORDER.record("compile", name=name, seconds=round(float(seconds), 3))

    @staticmethod
    def default_limit() -> Optional[int]:
        raw = os.environ.get("SHEEPRL_MAX_RECOMPILES", "").strip()
        return int(raw) if raw else None

    def count(self, name: str) -> int:
        with self._lock:
            return int(self._stats.get(name, {}).get("count", 0))

    def signatures(self, name: str) -> List[str]:
        with self._lock:
            return list(self._stats.get(name, {}).get("signatures", ()))

    def totals(self) -> Tuple[int, float]:
        """(programs built in all, seconds spent building them)."""
        with self._lock:
            return (sum(st["count"] for st in self._stats.values()),
                    sum(st["seconds"] for st in self._stats.values()))

    def summary(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {name: {"count": st["count"], "seconds": round(st["seconds"], 3),
                           "signatures": list(st["signatures"])} for name, st in self._stats.items()}

    def delta_report(self, mark: Tuple[int, float]) -> str:
        """One line of what was built since ``mark`` (from :meth:`totals`)."""
        count, seconds = self.totals()
        return f"{count - mark[0]} executables / {seconds - mark[1]:.1f}s compile"

    def compile_metrics(self) -> Dict[str, float]:
        """``Compile/*`` for the hub flush (empty before the first build)."""
        count, seconds = self.totals()
        if count == 0:
            return {}
        return {"Compile/executables": float(count), "Compile/compile_time_s": round(seconds, 3)}

    # hub-source alias: the hub polls ``metrics()`` on registered objects
    metrics = compile_metrics

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()


#: The process-global monitor every GraphFunction reports into.
COMPILE_MONITOR = CompileMonitor()


class CheckpointMonitor:
    """Accounting of the checkpoint writer: the writer thread and the
    manager's synchronous saves record, the hub surfaces ``Checkpoint/*``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._saves = 0
            self._async_saves = 0
            self._errors = 0
            self._bytes_total = 0
            self._seconds_total = 0.0
            self._last_seconds = 0.0
            self._last_bytes = 0
            self._max_depth = 0

    def record_save(self, seconds: float, nbytes: int, asynchronous: bool) -> None:
        with self._lock:
            self._saves += 1
            self._async_saves += 1 if asynchronous else 0
            self._bytes_total += int(nbytes)
            self._seconds_total += float(seconds)
            self._last_seconds = float(seconds)
            self._last_bytes = int(nbytes)
        RECORDER.record("ckpt.save", seconds=round(float(seconds), 4), bytes=int(nbytes),
                        asynchronous=bool(asynchronous))

    def record_error(self) -> None:
        with self._lock:
            self._errors += 1
        RECORDER.record("ckpt.error")

    def record_depth(self, depth: int) -> None:
        with self._lock:
            self._max_depth = max(self._max_depth, int(depth))

    def metrics(self) -> Dict[str, float]:
        """``Checkpoint/save_s`` is the last save's wall time — for an async
        save, writer-thread time overlapped with training."""
        with self._lock:
            if self._saves == 0:
                return {}
            return {
                "Checkpoint/save_s": round(self._last_seconds, 4),
                "Checkpoint/bytes": float(self._last_bytes),
                "Checkpoint/total_saves": float(self._saves),
                "Checkpoint/total_bytes": float(self._bytes_total),
                "Checkpoint/queue_depth_max": float(self._max_depth),
            }

    def totals(self) -> Dict[str, float]:
        with self._lock:
            return {"saves": self._saves, "async_saves": self._async_saves, "errors": self._errors,
                    "bytes": self._bytes_total, "seconds": round(self._seconds_total, 4)}


#: The process-global monitor the checkpoint writer reports into.
CHECKPOINT_MONITOR = CheckpointMonitor()


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
        RECORDER.record("retry.giveup", site=site)

    def record_stall(self, name: str = "") -> None:
        self._add("stalls")
        RECORDER.record("watchdog.stall", name=name)

    def record_env_restart(self, count: int = 1) -> None:
        self._add("env_restarts", count)
        RECORDER.record("env.restart", envs=int(count))

    def record_breaker(self, name: str, state: str) -> None:
        if state == "open":
            self._add("breaker_opens")
            RECORDER.record("breaker.open", name=name)

    def record_quarantine(self, path: Any = None) -> None:
        self._add("quarantined")
        RECORDER.record("ckpt.quarantine", path=str(path) if path is not None else None)

    def record_injection(self, site: str, kind: str) -> None:
        with self._lock:
            self._counts["injected"] += 1
            self._injected_by_site[site] = self._injected_by_site.get(site, 0) + 1
        RECORDER.record("fault.injected", site=site, fault=kind)

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


# one registration API, one flush contract
HUB.register("compile", COMPILE_MONITOR.compile_metrics)
HUB.register("checkpoint", CHECKPOINT_MONITOR.metrics)
HUB.register("resilience", RESILIENCE_MONITOR.metrics)
