"""Background checkpoint writer (counterpart of ``sheeprl_tpu/checkpoint/writer.py``).

One daemon thread drains a bounded queue of save jobs in order.  The caller
takes the snapshot (copies on the host) and enqueues; the thread serialises,
writes durably and commits.  A full queue blocks ``submit`` (back-pressure).

Liveness, as in the JAX writer:

* transient ``OSError``s are retried with jittered exponential backoff
  (:func:`~sheeprl_tpu_torch.resilience.retry.retry`,
  ``checkpoint.io_retries`` attempts) before the job's exception is parked;
* a job that still fails parks its exception, which the next ``submit`` or
  ``flush`` raises, so a failing disk cannot drop snapshots silently;
* a :class:`~sheeprl_tpu_torch.resilience.retry.Watchdog` armed around each
  job flags one that has made no progress for ``checkpoint.hang_warn_s``
  (``Resilience/watchdog_stalls`` and a warning);
* ``close()`` returns even when the worker is wedged on dead storage: every
  wait is bounded, and a worker that cannot be joined is abandoned with a
  warning (it is a daemon thread, so interpreter exit does not wait on it).

Each job runs inside a ``ckpt.snapshot`` span (writer-thread time, shown
as concurrent time in the phase breakdown), and its seconds and bytes, a
parked error and the queue's depth go to ``CHECKPOINT_MONITOR``
(``Checkpoint/*``).
"""

from __future__ import annotations

import queue
import threading
import time
import warnings
from typing import Any, Callable, Optional

from sheeprl_tpu_torch.resilience.retry import Watchdog, retry
from sheeprl_tpu_torch.telemetry.monitors import CHECKPOINT_MONITOR
from sheeprl_tpu_torch.telemetry.spans import span


def run_with_io_retry(job: Callable[[], Any], attempts: int, base_s: float) -> Any:
    """The transient-IO retry policy of every checkpoint write, shared by the
    writer thread and the manager's synchronous saves."""
    return retry(job, attempts=attempts, base_s=base_s, max_s=30.0, retry_on=(OSError,), site="checkpoint.write")


class AsyncCheckpointWriter:
    def __init__(self, queue_size: int = 2, io_retries: int = 3, io_retry_base_s: float = 0.5,
                 hang_warn_s: float = 120.0):
        self._queue: "queue.Queue[Optional[Callable[[], Any]]]" = queue.Queue(maxsize=max(1, int(queue_size)))
        self._error: Optional[BaseException] = None
        self._idle = threading.Event()
        self._idle.set()
        # counted before the put: between a submit's idle.clear() and its put
        # the worker, finishing the previous job, must not set idle again
        self._pending = 0
        self._pending_lock = threading.Lock()
        self._closed = False
        self._io_retries = max(1, int(io_retries))
        self._io_retry_base_s = float(io_retry_base_s)
        self._watchdog: Optional[Watchdog] = None
        if hang_warn_s and hang_warn_s > 0:
            self._watchdog = Watchdog(
                float(hang_warn_s),
                on_stall=lambda stalled: warnings.warn(
                    f"checkpoint writer job has made no progress for {stalled:.0f}s — storage may be wedged",
                    RuntimeWarning,
                ),
                name="ckpt-writer-watchdog",
            )
        self._thread = threading.Thread(target=self._loop, name="ckpt-writer", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                self._queue.task_done()
                return
            t0 = time.perf_counter()
            if self._watchdog is not None:
                self._watchdog.arm()
            try:
                with span("ckpt.snapshot"):
                    nbytes = run_with_io_retry(job, self._io_retries, self._io_retry_base_s)
                CHECKPOINT_MONITOR.record_save(seconds=time.perf_counter() - t0, nbytes=int(nbytes or 0),
                                               asynchronous=True)
            except BaseException as e:  # parked, raised on the next submit/flush
                self._error = e
                CHECKPOINT_MONITOR.record_error()
            finally:
                if self._watchdog is not None:
                    self._watchdog.disarm()
                self._queue.task_done()
                with self._pending_lock:
                    self._pending -= 1
                    if self._pending == 0:
                        self._idle.set()

    @property
    def in_flight(self) -> int:
        return self._queue.unfinished_tasks

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from err

    def submit(self, job: Callable[[], Any]) -> None:
        """Enqueue a save job (a callable returning the bytes written);
        blocks while the bounded queue is full."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointWriter is closed")
        self._raise_pending()
        with self._pending_lock:
            self._pending += 1
            self._idle.clear()
        self._queue.put(job)
        CHECKPOINT_MONITOR.record_depth(self.in_flight)

    def flush(self, timeout_s: Optional[float] = None) -> bool:
        """Wait until every queued job has finished, then raise a parked
        failure; returns False only on timeout."""
        done = self._idle.wait(timeout_s)
        self._raise_pending()
        return done

    def close(self, timeout_s: Optional[float] = 300.0) -> None:
        """Drain the queued jobs and stop the thread (idempotent), within
        about ``timeout_s`` even when the worker is wedged: the drain, the
        stop sentinel's put (a full queue behind a stuck job) and the join
        are all bounded, and a worker still alive is abandoned with a
        warning."""
        if self._closed:
            return
        self._closed = True
        drained = self._idle.wait(timeout_s)
        # the residual waits of the wedged path shrink with a small timeout_s
        grace = 5.0 if timeout_s is None else max(0.1, min(5.0, float(timeout_s)))
        try:
            self._queue.put(None, timeout=grace)
        except queue.Full:
            pass  # a wedged worker and a full queue: the join below gives up fast
        self._thread.join(timeout_s if drained else grace)
        if self._thread.is_alive():
            warnings.warn(
                f"checkpoint writer did not drain within {timeout_s if drained else grace}s; abandoning the daemon "
                f"thread with ~{max(self.in_flight, 1)} job(s) wedged (likely dead storage) — those snapshots stay "
                "uncommitted and are invisible to resume",
                RuntimeWarning,
            )
        if self._watchdog is not None:
            self._watchdog.close()
        self._raise_pending()
