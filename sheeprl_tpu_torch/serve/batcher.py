"""Continuous-batching engine: admission queue, coalescer, response scatter.

Requests land in a bounded FIFO :class:`AdmissionQueue` (backpressure: a
full queue blocks or raises :class:`QueueFull`).  A single dispatcher
thread coalesces the head of the queue into one batch under a
max-batch/max-wait policy — dispatch as soon as ``max_batch`` requests are
waiting, or when the OLDEST waiting request has aged ``max_wait_ms``,
whichever comes first — pads the batch up to the nearest static ladder
size (:func:`pick_ladder_size`), runs the player's step, and scatters
per-row results back to the callers' futures.

Padding to a fixed ladder keeps the set of batch shapes the step ever sees
small and known in advance: the service warms each rung once (cuDNN
algorithm choice, allocator pools), so no request pays a first-shape cost,
no matter how ragged the arrival process is.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


class QueueFull(RuntimeError):
    """Admission queue at capacity — the server is shedding load."""


class ServiceStopped(RuntimeError):
    """Request rejected/failed because the service is shutting down."""


def pick_ladder_size(n: int, ladder: Sequence[int]) -> int:
    """Smallest ladder batch size that fits ``n`` rows.

    ``n`` above the ladder top is a caller bug (the coalescer never takes
    more than ``max(ladder)`` requests) — raise instead of silently
    recompiling at an unwarmed shape.
    """
    if n <= 0:
        raise ValueError(f"batch of {n} rows")
    for size in sorted(ladder):
        if n <= size:
            return int(size)
    raise ValueError(f"batch of {n} rows exceeds the ladder top {max(ladder)}")


class _Request:
    __slots__ = ("obs", "greedy", "session", "enqueued", "event", "result", "error", "cancelled")

    def __init__(self, obs: Dict[str, np.ndarray], greedy: bool, session: Optional[str]):
        self.obs = obs
        self.greedy = bool(greedy)
        self.session = session
        self.enqueued = time.perf_counter()
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.cancelled = False

    # -- caller side -------------------------------------------------------
    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self.event.wait(timeout):
            # the caller is gone (HTTP 504): mark the still-queued request so
            # the dispatcher drops it instead of burning a batch slot and —
            # for stateful sessions — advancing the latent chain on an
            # observation the client will resend on retry (best-effort: a
            # dispatch that already started still completes normally)
            self.cancelled = True
            raise TimeoutError("policy request timed out")
        if self.error is not None:
            raise self.error
        return self.result

    def done(self) -> bool:
        return self.event.is_set()

    # -- dispatcher side ---------------------------------------------------
    def resolve(self, result: np.ndarray) -> None:
        self.result = result
        self.event.set()

    def fail(self, error: BaseException) -> None:
        self.error = error
        self.event.set()


class AdmissionQueue:
    """Bounded FIFO with coalescing pop.

    FIFO order is the fairness policy: requests are served strictly in
    arrival order, so no session can starve another, and the max-wait clock
    is anchored to the OLDEST waiting request.
    """

    def __init__(self, max_pending: int = 1024):
        self.max_pending = int(max_pending)
        self._items: deque = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._closed = False

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def put(self, req: _Request, block: bool = True, timeout: Optional[float] = None) -> None:
        with self._lock:
            if self._closed:
                raise ServiceStopped("admission queue closed")
            if len(self._items) >= self.max_pending:
                if not block:
                    raise QueueFull(
                        f"{len(self._items)} requests pending (max_pending={self.max_pending})"
                    )
                deadline = None if timeout is None else time.monotonic() + timeout
                while len(self._items) >= self.max_pending:
                    remaining = None if deadline is None else deadline - time.monotonic()
                    if remaining is not None and remaining <= 0:
                        raise QueueFull(
                            f"{len(self._items)} requests pending after {timeout}s "
                            f"(max_pending={self.max_pending})"
                        )
                    self._not_full.wait(remaining)
                    if self._closed:
                        raise ServiceStopped("admission queue closed")
            self._items.append(req)
            self._not_empty.notify()

    def get_batch(self, max_batch: int, max_wait_s: float) -> List[_Request]:
        """Block until at least one request is waiting, then collect up to
        ``max_batch`` requests, waiting at most ``max_wait_s`` past the
        oldest request's arrival for stragglers.  Returns ``[]`` only when
        the queue is closed and drained."""
        with self._lock:
            while not self._items:
                if self._closed:
                    return []
                self._not_empty.wait(0.1)
            # anchor the wait budget to the oldest request's age so a slow
            # trickle can't hold the head request hostage for max_wait each
            deadline = self._items[0].enqueued + max_wait_s
            while len(self._items) < max_batch and not self._closed:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._not_empty.wait(remaining)
            batch = []
            while self._items and len(batch) < max_batch:
                batch.append(self._items.popleft())
            self._not_full.notify_all()
            return batch

    def close(self) -> List[_Request]:
        """Stop admitting; return whatever was still pending (the service
        decides whether to serve or fail them)."""
        with self._lock:
            self._closed = True
            pending = list(self._items)
            self._items.clear()
            self._not_empty.notify_all()
            self._not_full.notify_all()
            return pending

    @property
    def closed(self) -> bool:
        return self._closed


class LatencyTracker:
    """Ring buffer of request latencies with percentile readout."""

    def __init__(self, window: int = 8192):
        self._lat = deque(maxlen=window)
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        with self._lock:
            self._lat.append(seconds)

    def percentiles(self, qs: Sequence[float] = (50, 99)) -> Dict[str, float]:
        with self._lock:
            data = np.asarray(self._lat, dtype=np.float64)
        if data.size == 0:
            return {f"p{int(q)}_ms": float("nan") for q in qs}
        return {f"p{int(q)}_ms": float(np.percentile(data, q) * 1e3) for q in qs}

    def count(self) -> int:
        with self._lock:
            return len(self._lat)
