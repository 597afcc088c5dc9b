"""Step-phase spans: nestable host-side timing with per-window breakdowns
(counterpart of ``sheeprl_tpu/telemetry/spans.py``).

The named timers (``utils/timer.py``) answer "how long did phase X take";
they cannot answer "what fraction of the window went where".  The span
tracker keeps a per-thread stack of open spans, attributes each span its
exclusive time (children subtracted), and aggregates a rolling window
into phase-breakdown fractions that sum to ~1.0 (an ``other`` bucket
absorbs untracked host time).

Span taxonomy (the JAX package's names):

* ``rollout``          — env interaction
* ``replay.write``     — host→ring staging of new rows (``DeviceReplay.add``)
* ``update.dispatch``  — the train window's dispatch (the sampling on the
  card's ring included — it is part of the same window)
* ``ckpt.snapshot``    — checkpoint serialize+write (the writer thread)

Wiring is central: ``utils.timer`` bridges the two phase timers every loop
already has (:data:`TIMER_PHASES`), and the checkpoint and replay layers
open their own spans.  Opening a top-level ``update.dispatch`` span also
ticks the trace scheduler (``tracer.py``), which is how trace windows count
updates without the loops knowing.

Device attribution: CUDA work is asynchronous, so a span's host time is
not its device time.  While a trace window is open (``TRACER.active``) or
``telemetry.spans.sync`` is set, span edges synchronise the device, making
phases attributable exactly when someone is looking; steady-state runs
never pay the fence.  Unlike the JAX fence, which swallows every error,
this one lets an error through: ``torch.cuda.synchronize`` is where an
asynchronous kernel fault surfaces, and hiding it would hide a failing
kernel.  A span edge reached while the current stream is capturing a CUDA
graph does not fence (a capture may not synchronise).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional

from sheeprl_tpu_torch.telemetry.hub import HUB
from sheeprl_tpu_torch.telemetry.recorder import RECORDER
from sheeprl_tpu_torch.telemetry.tracer import TRACER

#: timer-name → span-phase bridge (utils/timer.py opens these automatically,
#: which is what wires all 12 algo loops without touching them)
TIMER_PHASES: Dict[str, str] = {
    "Time/env_interaction_time": "rollout",
    "Time/train_time": "update.dispatch",
}

_now = time.perf_counter


class _Span:
    __slots__ = ("name", "start", "child_s")

    def __init__(self, name: str, start: float) -> None:
        self.name = name
        self.start = start
        self.child_s = 0.0


class SpanTracker:
    """Process-global span stack (per-thread) + windowed phase aggregator."""

    def __init__(self) -> None:
        self.enabled = True
        self.sync = False
        self._lock = threading.Lock()
        self._local = threading.local()
        self._excl: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._window_start = _now()
        # liveness signal for /healthz (introspect.py): wall time of the
        # newest COMPLETED top-level update.dispatch span + total count —
        # survives window rolls, so a stalled learner is visible however
        # long it has been wedged
        self._last_update_done: Optional[float] = None
        self._updates_done = 0

    # -- configuration -------------------------------------------------------
    def configure(self, cfg: Any = None) -> None:
        """Apply the ``telemetry.spans`` config group."""
        cfg = cfg or {}
        self.enabled = bool(cfg.get("enabled", True))
        self.sync = bool(cfg.get("sync", False))

    # -- the span stack ------------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @staticmethod
    def _fence() -> None:
        """Wait for the device's queued work; a CUDA error raises here.
        (torch is imported here: an env worker imports this module without it.)"""
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return
        if torch.cuda.is_current_stream_capturing():
            return
        torch.cuda.synchronize()

    def push(self, name: str) -> Optional[_Span]:
        """Open a span; returns the token :meth:`pop` needs (None when
        disabled — pop of None is a no-op, so call sites stay branch-free)."""
        if not self.enabled:
            return None
        stack = self._stack()
        if name == "update.dispatch" and not stack:
            # the update tick stream the trace scheduler counts on
            TRACER.tick()
        if self.sync or TRACER.active:
            self._fence()
        span = _Span(name, _now())
        stack.append(span)
        return span

    def pop(self, token: Optional[_Span]) -> None:
        """Close ``token`` (and any span opened under it that leaked — a
        raise between push and pop unwinds with the parent)."""
        if token is None:
            return
        if self.sync or TRACER.active:
            self._fence()
        stack = self._stack()
        end = _now()
        while stack:
            span = stack.pop()
            dur = max(0.0, end - span.start)
            excl = max(0.0, dur - span.child_s)
            if stack:
                stack[-1].child_s += dur
            with self._lock:
                self._excl[span.name] = self._excl.get(span.name, 0.0) + excl
                self._counts[span.name] = self._counts.get(span.name, 0) + 1
            if not stack:
                # top-level span edges are flight-recorder events (bounded
                # ring — per-update cadence, not per-env-step)
                RECORDER.record("span", name=span.name, seconds=round(dur, 6))
                if span.name == "update.dispatch":
                    with self._lock:
                        self._last_update_done = time.time()
                        self._updates_done += 1
            if span is token:
                return

    @contextmanager
    def span(self, name: str):
        token = self.push(name)
        try:
            yield token
        finally:
            self.pop(token)

    def depth(self) -> int:
        return len(self._stack())

    # -- liveness ------------------------------------------------------------
    def last_update_age_s(self) -> Optional[float]:
        """Seconds since the newest completed update dispatch (None before
        the first one — warm-up compiles can legitimately take many
        minutes, so pre-first-update runs are never called stalled)."""
        with self._lock:
            if self._last_update_done is None:
                return None
            return max(0.0, time.time() - self._last_update_done)

    @property
    def updates_done(self) -> int:
        with self._lock:
            return self._updates_done

    # -- window aggregation --------------------------------------------------
    def breakdown(self) -> Dict[str, Any]:
        """The current window's phase breakdown.

        Fractions are normalized against ``max(window wall, Σ exclusive)``:
        spans on concurrent threads (the checkpoint writer overlapping the
        learner) can legitimately sum past wall time, and the breakdown
        must still sum to ~1.0.  ``other_frac`` is the untracked remainder
        of the window wall."""
        with self._lock:
            excl = dict(self._excl)
            counts = dict(self._counts)
            window_s = max(_now() - self._window_start, 1e-9)
        tracked = sum(excl.values())
        total = max(window_s, tracked)
        phases = {
            name: {
                "seconds": round(s, 6),
                "frac": round(s / total, 6),
                "count": counts.get(name, 0),
            }
            for name, s in sorted(excl.items())
        }
        return {
            "window_s": round(window_s, 6),
            "phases": phases,
            "other_frac": round(max(0.0, window_s - tracked) / total, 6),
        }

    def metrics(self) -> Dict[str, float]:
        """``Phase/*`` fractions for the hub flush (empty when no span
        closed this window — a run with spans disabled emits nothing)."""
        bd = self.breakdown()
        if not bd["phases"]:
            return {}
        out = {f"Phase/{name}": p["frac"] for name, p in bd["phases"].items()}
        out["Phase/other"] = bd["other_frac"]
        return out

    def roll_window(self) -> None:
        """Start a fresh aggregation window (fired by the per-interval
        metric flush via the hub's ``on_roll`` hook)."""
        with self._lock:
            self._excl.clear()
            self._counts.clear()
            self._window_start = _now()

    def reset(self) -> None:
        """Tests: fresh window + default knobs (per-thread stacks drain
        naturally as their context managers exit)."""
        self.roll_window()
        self.enabled = True
        self.sync = False
        with self._lock:
            self._last_update_done = None
            self._updates_done = 0


#: The process-global span tracker.
SPANS = SpanTracker()

#: Module-level convenience: ``with span("replay.write"): ...``
span = SPANS.span

HUB.register("spans", SPANS.metrics, on_roll=SPANS.roll_window)
