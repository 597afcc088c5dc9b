"""Recovery primitives: jittered-backoff retry, hang watchdog, circuit breaker
(counterpart of ``sheeprl_tpu/resilience/retry.py``, copied: the module has
no JAX in it).

Every primitive reports into
:data:`sheeprl_tpu_torch.telemetry.monitors.RESILIENCE_MONITOR`, whose
``Resilience/*`` counters reach every metric flush through the telemetry
hub and whose notable transitions land in the flight recorder, so no
handle is threaded through the loops.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Optional, Tuple, Type

from sheeprl_tpu_torch.telemetry.monitors import RESILIENCE_MONITOR


def retry(
    fn: Callable[[], Any],
    *,
    attempts: int = 3,
    base_s: float = 0.2,
    max_s: float = 10.0,
    multiplier: float = 2.0,
    jitter: float = 0.5,
    deadline_s: Optional[float] = None,
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
    should_retry: Optional[Callable[[BaseException], bool]] = None,
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    site: str = "",
) -> Any:
    """Call ``fn()`` with jittered exponential backoff.

    * ``attempts`` — total tries (1 = no retry).
    * ``base_s * multiplier**k`` capped at ``max_s`` is the k-th sleep; the
      actual sleep is uniformly drawn from ``[sleep*(1-jitter), sleep]`` so
      a fleet of workers retrying the same dead disk doesn't stampede.
    * ``deadline_s`` — total wall budget including sleeps: when the next
      sleep would cross it, the last error re-raises immediately.
    * ``retry_on`` / ``should_retry`` — which exceptions are transient;
      anything else propagates on first occurrence.
    * ``site`` labels the ``Resilience/*`` accounting.
    """
    attempts = max(1, int(attempts))
    deadline = None if deadline_s is None else time.monotonic() + float(deadline_s)
    last: Optional[BaseException] = None
    for attempt in range(attempts):
        try:
            out = fn()
            if attempt:
                RESILIENCE_MONITOR.record_retry_success(site)
            return out
        except retry_on as e:
            if should_retry is not None and not should_retry(e):
                raise
            last = e
            if attempt == attempts - 1:
                break
            sleep = min(float(max_s), float(base_s) * float(multiplier) ** attempt)
            sleep -= sleep * float(jitter) * random.random()
            if deadline is not None and time.monotonic() + sleep > deadline:
                break
            RESILIENCE_MONITOR.record_retry(site)
            if on_retry is not None:
                on_retry(attempt + 1, e, sleep)
            time.sleep(sleep)
    RESILIENCE_MONITOR.record_giveup(site)
    assert last is not None
    raise last


class Watchdog:
    """Heartbeat-based hang detector.

    The owner calls :meth:`beat` whenever it makes progress; a daemon thread
    checks every ``interval_s`` whether the last beat is older than
    ``timeout_s`` while the watchdog is :meth:`armed <arm>`, and fires
    ``on_stall(stalled_for_s)`` ONCE per stall (re-arming after the next
    beat).  Use it to watch work that has no timeout-taking wait of its own
    (a background writer job, a dispatch loop); prefer a native timeout
    (e.g. ``AsyncVectorEnv.step_wait(timeout=...)``) where one exists.
    """

    def __init__(
        self,
        timeout_s: float,
        on_stall: Optional[Callable[[float], None]] = None,
        interval_s: Optional[float] = None,
        name: str = "watchdog",
    ):
        self.timeout_s = float(timeout_s)
        self._interval = float(interval_s) if interval_s else max(0.05, self.timeout_s / 4)
        self._on_stall = on_stall
        self._name = name
        self._lock = threading.Lock()
        self._last_beat = time.monotonic()
        self._armed = False
        self._fired = False
        self.stalls = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    # -- owner API -----------------------------------------------------------
    def beat(self) -> None:
        with self._lock:
            self._last_beat = time.monotonic()
            self._fired = False

    def arm(self) -> None:
        with self._lock:
            self._armed = True
            self._last_beat = time.monotonic()
            self._fired = False

    def disarm(self) -> None:
        with self._lock:
            self._armed = False

    def watching(self) -> "_WatchdogContext":
        """``with wd.watching():`` — arm for the block, disarm on exit."""
        return _WatchdogContext(self)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(self._interval * 2 + 1.0)

    # -- checker -------------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            with self._lock:
                if not self._armed or self._fired:
                    continue
                stalled = time.monotonic() - self._last_beat
                if stalled < self.timeout_s:
                    continue
                self._fired = True  # once per stall
                self.stalls += 1
            RESILIENCE_MONITOR.record_stall(self._name)
            if self._on_stall is not None:
                try:
                    self._on_stall(stalled)
                except Exception:
                    pass  # a broken stall handler must not kill the checker


class _WatchdogContext:
    def __init__(self, wd: Watchdog):
        self._wd = wd

    def __enter__(self) -> Watchdog:
        self._wd.arm()
        return self._wd

    def __exit__(self, *exc: Any) -> None:
        self._wd.disarm()


class CircuitBreaker:
    """Classic closed → open → half-open breaker.

    ``record_failure()`` after ``failure_threshold`` consecutive failures
    opens the circuit; :meth:`allow` then answers False for
    ``reset_timeout_s``, after which ONE probe is allowed through
    (half-open) — its ``record_success`` closes the circuit, its
    ``record_failure`` re-opens it for another cool-down.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(
        self, failure_threshold: int = 3, reset_timeout_s: float = 30.0, name: str = "breaker"
    ):
        self.failure_threshold = max(1, int(failure_threshold))
        self.reset_timeout_s = float(reset_timeout_s)
        self.name = name
        self._lock = threading.Lock()
        self._failures = 0
        self._state = self.CLOSED
        self._opened_at = 0.0
        self.opens = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._probe_state()

    @property
    def failures(self) -> int:
        with self._lock:
            return self._failures

    def _probe_state(self) -> str:
        # lock held: open → half_open once the cool-down elapsed
        if self._state == self.OPEN and (
            time.monotonic() - self._opened_at >= self.reset_timeout_s
        ):
            self._state = self.HALF_OPEN
        return self._state

    def allow(self) -> bool:
        """May the protected call proceed right now?"""
        with self._lock:
            return self._probe_state() != self.OPEN

    def record_success(self) -> None:
        with self._lock:
            if self._state != self.CLOSED:
                RESILIENCE_MONITOR.record_breaker(self.name, self.CLOSED)
            self._failures = 0
            self._state = self.CLOSED

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            state = self._probe_state()
            if state == self.HALF_OPEN or (
                state == self.CLOSED and self._failures >= self.failure_threshold
            ):
                self._state = self.OPEN
                self._opened_at = time.monotonic()
                self.opens += 1
                RESILIENCE_MONITOR.record_breaker(self.name, self.OPEN)

    def snapshot(self) -> dict:
        """State dict for ``/healthz`` / ``/v1/stats`` surfaces."""
        with self._lock:
            return {
                "state": self._probe_state(),
                "failures": self._failures,
                "threshold": self.failure_threshold,
                "opens": self.opens,
            }
