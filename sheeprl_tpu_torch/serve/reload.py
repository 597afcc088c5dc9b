"""Hot checkpoint reload: COMMIT watcher + in-place parameter install
(counterpart of ``sheeprl_tpu/serve/reload.py``).

:class:`ParamStore` owns the parameters the dispatcher reads: the player's
modules.  :class:`CommitWatcher` polls the run's checkpoint directory for a
newer ``COMMIT`` marker (``checkpoint.protocol.newer_checkpoint``),
CRC-verifies the snapshot, loads it on its own thread into pinned host
memory and stages it to the card on a side stream, while the old
parameters keep serving; then it copies the staged tensors into the live
ones between two batches.

Why in place, where JAX swaps a reference: the served step is a captured
CUDA graph per ladder rung (``serve/players.py``), which reads the
addresses of the modules' tensors it saw at capture.  A new set of tensors
would change nothing the graph reads; a copy into the captured addresses
changes what it computes and recaptures nothing.  JAX's rule holds all the
same: a batch that started on generation N finishes on N, because the
dispatcher holds the store's lock for the whole batch (:meth:`ParamStore.
serving`) and the install takes the same lock, so the copy lands between
batches, on the stream the batches run on.  The pause a reload puts on
serving is one device-to-device copy of the parameters.

Failure containment (the resilience layer): a load failure never
interrupts serving — the store keeps the old parameters.  A
:class:`~sheeprl_tpu_torch.resilience.retry.CircuitBreaker` counts
consecutive failures; after ``failure_threshold`` failed loads of the same
snapshot that snapshot is quarantined (``step_*.corrupt``), so discovery
moves on to the next commit.  While the breaker is open the watcher skips
load attempts for its cool-down; the breaker's state is in ``/healthz``
(``degraded: true``) and ``/v1/stats``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from sheeprl_tpu_torch.resilience.retry import CircuitBreaker


def live_tensors(params: Dict[str, torch.nn.Module]) -> List[Tuple[str, torch.Tensor]]:
    """``(module.key, tensor)`` of every parameter and buffer of the player's
    modules, in a fixed order: the tensors a captured step reads."""
    out = []
    for name, module in params.items():
        for key, t in module.state_dict(keep_vars=True).items():
            out.append((f"{name}.{key}", t.data if isinstance(t, torch.nn.Parameter) else t))
    return out


class StagedParams:
    """A snapshot's parameters laid out as the live ones, ready to install:
    on the card, staged there from pinned host memory on a side stream; on
    the CPU, the loaded host tensors."""

    def __init__(self, live: List[Tuple[str, torch.Tensor]], state: Dict[str, Dict[str, torch.Tensor]]):
        new = {f"{name}.{key}": t for name, sd in state.items() for key, t in sd.items()}
        missing = sorted({k for k, _ in live} - set(new))
        unexpected = sorted(set(new) - {k for k, _ in live})
        if missing or unexpected:
            raise ValueError(f"snapshot does not match the served modules: missing {missing[:5]}, "
                             f"unexpected {unexpected[:5]}")
        for key, t in live:
            got = new[key]
            if tuple(got.shape) != tuple(t.shape) or got.dtype != t.dtype:
                raise ValueError(f"snapshot tensor {key} is {tuple(got.shape)}/{got.dtype}, "
                                 f"served as {tuple(t.shape)}/{t.dtype}")
        self.live = [t for _, t in live]
        device = self.live[0].device if self.live else torch.device("cpu")
        if device.type == "cuda":
            pinned = [new[k].contiguous().pin_memory() for k, _ in live]
            side = torch.cuda.Stream(device)
            with torch.cuda.stream(side):
                self.tensors = [torch.empty_like(t) for t in self.live]
                for dst, src in zip(self.tensors, pinned):
                    dst.copy_(src, non_blocking=True)
            side.synchronize()
        else:
            self.tensors = [new[k].to(device) for k, _ in live]

    def copy_into_live(self) -> None:
        """Copy the staged tensors into the live ones on the current stream
        (the dispatcher's), and wait for it."""
        with torch.no_grad():
            if self.live:
                torch._foreach_copy_(self.live, self.tensors)
        if self.live and self.live[0].is_cuda:
            torch.cuda.current_stream(self.live[0].device).synchronize()


class ParamStore:
    """Versioned, thread-safe holder of the serving parameters."""

    def __init__(self, params: Any, step: int = -1):
        self._lock = threading.Lock()
        # held by a batch for its whole dispatch, and by an install
        self._use = threading.Lock()
        self._params = params
        self._generation = 0
        self._step = int(step)
        #: seconds the newest install held the store (the pause it put on serving)
        self.last_install_s = 0.0

    def get(self) -> Any:
        with self._lock:
            return self._params

    def snapshot(self) -> tuple:
        """(params, generation, checkpoint_step) under one lock hold."""
        with self._lock:
            return self._params, self._generation, self._step

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    @property
    def step(self) -> int:
        with self._lock:
            return self._step

    @contextlib.contextmanager
    def serving(self) -> Iterator[tuple]:
        """Hold the parameters for one batch: :meth:`snapshot` under the
        lock an install waits on."""
        with self._use:
            yield self.snapshot()

    def install(self, staged: StagedParams, step: int) -> int:
        """Copy ``staged`` into the live parameters between two batches;
        returns the new generation."""
        with self._use:
            t0 = time.perf_counter()
            staged.copy_into_live()
            self.last_install_s = time.perf_counter() - t0
            with self._lock:
                self._step = int(step)
                self._generation += 1
                return self._generation


class CommitWatcher:
    """Background thread installing the parameters of every new ``COMMIT``."""

    def __init__(
        self,
        ckpt_root: Any,
        store: ParamStore,
        load_params: Callable[[Any], StagedParams],
        poll_s: float = 2.0,
        on_reload: Optional[Callable[[int, int], None]] = None,
        failure_threshold: int = 3,
        breaker_reset_s: float = 30.0,
        quarantine: bool = True,
    ):
        """``load_params(step_dir) -> StagedParams`` reads the snapshot and
        stages it beside the live parameters (built by the service from the
        player's extract rule); ``on_reload(generation, step)`` is a
        notification hook.  ``failure_threshold`` consecutive failed loads
        of the same snapshot quarantine it (when ``quarantine``) and open
        the breaker for ``breaker_reset_s``."""
        self._ckpt_root = ckpt_root
        self._store = store
        self._load_params = load_params
        self._poll_s = float(poll_s)
        self._on_reload = on_reload
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._poll_lock = threading.Lock()
        self._quarantine = bool(quarantine)
        self.breaker = CircuitBreaker(failure_threshold=failure_threshold, reset_timeout_s=breaker_reset_s,
                                      name="serve.reload")
        # consecutive-failure tracking is per snapshot: a new commit landing
        # mid-streak gets a fresh budget
        self._failing_step: Optional[int] = None
        self._failing_count = 0
        self.reloads = 0
        self.quarantined = 0
        self.last_error: Optional[str] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name="sheeprl-serve-reload", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

    @property
    def degraded(self) -> bool:
        """Serving old parameters because new commits cannot be loaded."""
        return self.breaker.state != CircuitBreaker.CLOSED

    def poll_once(self) -> Optional[int]:
        """One synchronous check (also the HTTP ``/v1/reload`` endpoint's):
        install a newer commit if one exists and return the new generation,
        else None.  Serialised by a lock, so a slow load of step N cannot
        land after a faster poll already installed N+1; the entry check
        rereads ``store.step``, so the loser just no-ops."""
        from sheeprl_tpu_torch.checkpoint.protocol import checkpoint_step, newer_checkpoint, verify_checkpoint

        with self._poll_lock:
            found = newer_checkpoint(self._ckpt_root, self._store.step)
            if found is None:
                return None
            if not self.breaker.allow():
                # open breaker: keep serving the old parameters, retry after
                # the cool-down (half-open probe)
                return None
            found_step = checkpoint_step(found)
            try:
                # CRC-verify before unpickling: a bit flip in raw tensor data
                # loads "successfully" into poisoned parameters
                problems = verify_checkpoint(found)
                if problems:
                    raise IOError(f"snapshot failed verification: {'; '.join(problems)}")
                staged = self._load_params(found)
            except Exception as e:  # a torn read, an OOM, a mismatched snapshot: keep serving
                self.last_error = f"{type(e).__name__}: {e}"
                self._record_failure(found, found_step)
                return None
            gen = self._store.install(staged, found_step)
            del staged
            self.reloads += 1
            self.last_error = None
            self._failing_step, self._failing_count = None, 0
            self.breaker.record_success()
            if self._on_reload is not None:
                self._on_reload(gen, self._store.step)
            return gen

    def _record_failure(self, found: Any, found_step: int) -> None:
        """Count consecutive failures of one snapshot; at the threshold,
        quarantine it so discovery moves past it."""
        if self._failing_step == found_step:
            self._failing_count += 1
        else:
            self._failing_step, self._failing_count = found_step, 1
        self.breaker.record_failure()
        if self._quarantine and self._failing_count >= self.breaker.failure_threshold:
            from sheeprl_tpu_torch.checkpoint.protocol import quarantine_checkpoint

            target = quarantine_checkpoint(found)
            if target is not None:
                self.quarantined += 1
                self.last_error = f"{self.last_error} — quarantined {found} after {self._failing_count} failed loads"
            self._failing_step, self._failing_count = None, 0

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as e:  # never let the watcher die silently
                self.last_error = f"{type(e).__name__}: {e}"
            self._stop.wait(self._poll_s)
