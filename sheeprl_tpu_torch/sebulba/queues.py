"""Sebulba dataflow queues (counterpart of ``sheeprl_tpu/sebulba/queues.py``):
the shared observation queue and the trajectory queue.

* :class:`ObsQueue` is the actor-side admission path: env workers submit
  fixed-shape observation *blocks* (one per worker per step) and the actor
  dispatcher coalesces the head of the queue into one padded inference
  batch, the ``serve/batcher.py`` continuous-batching pattern (bounded FIFO,
  max-batch/max-wait anchored to the oldest block).

* :class:`TrajQueue` is the learner-side trajectory ring: a bounded queue of
  rollout segments whose payloads live on the learner's device (host leaves
  staged through pinned memory, ``data/device_replay.py::stage``).  A full
  queue **blocks producers** (backpressure: trajectories are never
  dropped), and its depth is tracked.  A segment staged on one thread's
  stream is consumed on another's: ``put`` records an event on the
  producer's stream, and ``get_many`` makes the consumer's stream wait on it
  and marks the segment's tensors as used there, so the caching allocator
  does not hand their memory back to the producer early.

A ``truncate`` fault at the ``sebulba.traj_queue`` site models a torn
segment: :meth:`TrajQueue.put` **rejects** it (validation of the time axis)
instead of feeding the learner a short rollout.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.data.device_replay import stage
from sheeprl_tpu_torch.resilience.faults import fault_rows
from sheeprl_tpu_torch.serve.batcher import AdmissionQueue, QueueFull, ServiceStopped  # noqa: F401
from sheeprl_tpu_torch.telemetry.recorder import RECORDER


class TornTrajectory(ValueError):
    """A segment whose leading (time) axis does not match the queue's
    contract, e.g. a ``sebulba.traj_queue`` truncate fault."""


class ObsBlock:
    """One env worker's observation block awaiting actor inference (the
    batcher's request: ``enqueued`` anchors the coalescer's max-wait, and a
    ``cancelled`` block of a deposed worker is skipped)."""

    __slots__ = ("worker_id", "obs", "rows", "enqueued", "event", "result", "error", "cancelled")

    def __init__(self, worker_id: int, obs: Dict[str, np.ndarray], rows: int):
        self.worker_id = int(worker_id)
        self.obs = obs
        self.rows = int(rows)
        self.enqueued = time.perf_counter()
        self.event = threading.Event()
        self.result: Optional[Dict[str, np.ndarray]] = None
        self.error: Optional[BaseException] = None
        self.cancelled = False

    def wait(self, timeout: Optional[float] = None) -> Dict[str, np.ndarray]:
        if not self.event.wait(timeout):
            self.cancelled = True
            raise TimeoutError("actor inference request timed out")
        if self.error is not None:
            raise self.error
        return self.result

    def resolve(self, result: Dict[str, np.ndarray]) -> None:
        self.result = result
        self.event.set()

    def fail(self, error: BaseException) -> None:
        self.error = error
        self.event.set()


class ObsQueue(AdmissionQueue):
    """The shared observation queue (bounded FIFO + coalescing pop)."""

    def __init__(self, max_pending: int):
        super().__init__(max_pending=max_pending)


class _DepthMeter:
    """Time-weighted queue-depth integral: ``frac()`` is the average
    fraction of capacity occupied since :meth:`start`."""

    def __init__(self, capacity: int):
        self.capacity = max(1, int(capacity))
        self._depth = 0
        self._t0 = time.perf_counter()
        self._last = self._t0
        self._area = 0.0
        self._max = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._last = self._t0
        self._area = 0.0

    def move(self, delta: int) -> None:
        now = time.perf_counter()
        self._area += self._depth * (now - self._last)
        self._last = now
        self._depth += delta
        self._max = max(self._max, self._depth)

    def frac(self) -> float:
        now = time.perf_counter()
        area = self._area + self._depth * (now - self._last)
        return area / (self.capacity * max(now - self._t0, 1e-9))

    @property
    def max_depth(self) -> int:
        return self._max


def _time_rows(v: Any) -> int:
    shape = tuple(v.shape) if hasattr(v, "shape") else np.shape(v)
    return int(shape[0]) if shape else -1


class TrajQueue:
    """Bounded trajectory queue on the learner's device.

    ``put`` stages a rollout segment (dict of ``(T, B, *feat)`` arrays plus
    optional ``(B, *feat)`` bootstrap leaves) and appends it; while
    ``capacity`` segments are pending the producer **blocks**.
    ``get_many(n)`` pops the ``n`` oldest segments for one learner update.
    ``stage=False`` keeps payloads on the host (the SAC runtime appends them
    into its own replay ring; the queue adds ordering and backpressure).
    Leaves that are already tensors (a fused actor's segment, copied off its
    graph's outputs) are queued as they are.  Segment metadata travels
    alongside: the param version it was collected with, its worker id, its
    env-step count."""

    def __init__(
        self,
        capacity: int,
        rollout_steps: int,
        learner_fabric: Any = None,
        *,
        stage: bool = True,
        bootstrap_keys: Tuple[str, ...] = (),
        timeout_s: float = 300.0,
    ):
        self.capacity = max(1, int(capacity))
        self.rollout_steps = int(rollout_steps)
        self.learner_fabric = learner_fabric
        self.stage = bool(stage) and learner_fabric is not None
        self.bootstrap_keys = tuple(bootstrap_keys)
        self.timeout_s = float(timeout_s)
        self._items: List[Tuple[Dict[str, Any], Dict[str, Any], Any]] = []
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._closed = False
        self._meter = _DepthMeter(self.capacity)
        self._meter.start()
        self.torn_rejected = 0
        self.put_wait_s = 0.0
        self.get_wait_s = 0.0
        self.total_put = 0

    # -- staging --------------------------------------------------------------
    def _stage(self, segment: Dict[str, Any]) -> Dict[str, Any]:
        """Land the segment's host leaves on the learner's device."""
        device = self.learner_fabric.device
        return {k: v if isinstance(v, torch.Tensor) else stage(np.asarray(v), device) for k, v in segment.items()}

    @staticmethod
    def _ready_event(segment: Dict[str, Any]) -> Any:
        """An event on the producer's stream after the segment's last write
        (None without a CUDA tensor)."""
        for v in segment.values():
            if isinstance(v, torch.Tensor) and v.is_cuda:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(v.device))
                return event
        return None

    def _validate(self, segment: Dict[str, Any]) -> None:
        for k, v in segment.items():
            if k in self.bootstrap_keys:
                continue
            t = _time_rows(v)
            if t != self.rollout_steps:
                raise TornTrajectory(
                    f"segment leaf '{k}' has {t} rows, expected "
                    f"rollout_steps={self.rollout_steps} — torn trajectory "
                    "rejected (never enqueued)"
                )

    # -- producer -------------------------------------------------------------
    def put(self, segment: Dict[str, Any], meta: Optional[Dict[str, Any]] = None, abort: Optional[Any] = None) -> None:
        """Stage + append one segment; blocks while the ring is full.

        ``abort`` (a callable) is evaluated under the queue lock on every
        backpressure wait slice and immediately before the append: a
        producer whose ``abort()`` turns true (a deposed env worker) backs
        out with :class:`ServiceStopped` instead of delivering a stale
        segment (the generation fence that keeps a respawn from duplicating
        trajectories).

        The ``sebulba.traj_queue`` fault site acts here: ``latency``/``hang``
        delay the producer, ``raise`` fails it (the worker respawn path),
        ``truncate`` tears the segment, which the validation then rejects
        with :class:`TornTrajectory`."""
        rollout_leaves = {k: v for k, v in segment.items() if k not in self.bootstrap_keys}
        rollout_leaves = fault_rows("sebulba.traj_queue", rollout_leaves)
        segment = {**segment, **rollout_leaves}
        try:
            self._validate(segment)
        except TornTrajectory:
            with self._lock:
                self.torn_rejected += 1
            raise
        staged = self._stage(segment) if self.stage else segment
        ready = self._ready_event(staged)
        deadline = time.monotonic() + self.timeout_s
        t0 = time.perf_counter()
        with self._lock:
            while len(self._items) >= self.capacity and not self._closed:
                if abort is not None and abort():
                    raise ServiceStopped("producer deposed while waiting")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise QueueFull(
                        f"trajectory queue full ({self.capacity} segments) "
                        f"for {self.timeout_s}s — learner wedged?"
                    )
                self._not_full.wait(min(remaining, 0.2))
            if self._closed:
                raise ServiceStopped("trajectory queue closed")
            if abort is not None and abort():
                raise ServiceStopped("producer deposed while waiting")
            self.put_wait_s += time.perf_counter() - t0
            self._items.append((staged, dict(meta or {}), ready))
            self.total_put += 1
            self._meter.move(+1)
            self._not_empty.notify_all()

    # -- consumer -------------------------------------------------------------
    @staticmethod
    def _adopt(segment: Dict[str, Any], ready: Any) -> None:
        """Order the consumer's stream after the producer's writes, and keep
        the segment's memory until the consumer's stream has used it."""
        if ready is None:
            return
        stream = torch.cuda.current_stream()
        stream.wait_event(ready)
        for v in segment.values():
            if isinstance(v, torch.Tensor) and v.is_cuda:
                v.record_stream(stream)

    def get_many(self, n: int, timeout_s: Optional[float] = None) -> List[Tuple[Dict[str, Any], Dict[str, Any]]]:
        """Pop the ``n`` oldest segments (blocking).  Returns fewer only when
        the queue is closed and drained."""
        effective = self.timeout_s if timeout_s is None else float(timeout_s)
        deadline = time.monotonic() + effective
        t0 = time.perf_counter()
        with self._lock:
            while len(self._items) < n and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"trajectory queue: {len(self._items)}/{n} segments "
                        f"after {effective}s — actors wedged?"
                    )
                self._not_empty.wait(min(remaining, 0.2))
            self.get_wait_s += time.perf_counter() - t0
            take = min(n, len(self._items))
            # per-pop depth sample for the flight recorder: a postmortem shows
            # whether the queue was starved or backed up when the run died
            RECORDER.record("queue.depth", depth=len(self._items), frac=round(self._meter.frac(), 4))
            out, self._items = self._items[:take], self._items[take:]
            self._meter.move(-take)
            self._not_full.notify_all()
        for segment, _, ready in out:
            self._adopt(segment, ready)
        return [(segment, meta) for segment, meta, _ in out]

    def qsize(self) -> int:
        with self._lock:
            return len(self._items)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    # -- observability --------------------------------------------------------
    def metrics(self) -> Dict[str, float]:
        with self._lock:
            return {
                "Sebulba/queue_depth": float(len(self._items)),
                "Sebulba/queue_depth_frac": float(self._meter.frac()),
                "Sebulba/queue_depth_max": float(self._meter.max_depth),
                "Sebulba/queue_put_wait_s": float(self.put_wait_s),
                "Sebulba/queue_get_wait_s": float(self.get_wait_s),
                "Sebulba/queue_torn_rejected": float(self.torn_rejected),
                "Sebulba/queue_total_put": float(self.total_put),
            }
