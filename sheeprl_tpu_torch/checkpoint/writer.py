"""Background checkpoint writer (counterpart of ``sheeprl_tpu/checkpoint/writer.py``).

One daemon thread drains a bounded queue of save jobs in order.  The caller
takes the snapshot (copies on the host) and enqueues; the thread serialises,
writes durably and commits.  A full queue blocks ``submit`` (back-pressure).
Transient ``OSError``s are retried with exponential backoff; a job that
still fails parks its exception, which the next ``submit`` or ``flush``
raises, so a failing disk cannot drop snapshots silently.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Optional


def run_with_io_retry(job: Callable[[], Any], attempts: int, base_s: float) -> Any:
    """Run ``job``, retrying ``OSError`` up to ``attempts`` times in all."""
    for attempt in range(max(1, int(attempts))):
        try:
            return job()
        except OSError:
            if attempt + 1 >= attempts:
                raise
            time.sleep(min(30.0, base_s * 2**attempt))


class AsyncCheckpointWriter:
    def __init__(self, queue_size: int = 2, io_retries: int = 3, io_retry_base_s: float = 0.5):
        self._queue: "queue.Queue[Optional[Callable[[], Any]]]" = queue.Queue(maxsize=max(1, int(queue_size)))
        self._error: Optional[BaseException] = None
        self._io_retries = max(1, int(io_retries))
        self._io_retry_base_s = float(io_retry_base_s)
        self._thread = threading.Thread(target=self._loop, name="ckpt-writer", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            job = self._queue.get()
            try:
                if job is None:
                    return
                run_with_io_retry(job, self._io_retries, self._io_retry_base_s)
            except BaseException as e:  # parked, raised on the next submit/flush
                self._error = e
            finally:
                self._queue.task_done()

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from err

    def submit(self, job: Callable[[], Any]) -> None:
        self._raise_pending()
        self._queue.put(job)

    def flush(self) -> None:
        """Wait for every queued job, then raise a parked failure."""
        self._queue.join()
        self._raise_pending()

    def close(self, timeout_s: Optional[float] = 300.0) -> None:
        self._queue.join()
        self._queue.put(None)
        self._thread.join(timeout_s)
        self._raise_pending()
