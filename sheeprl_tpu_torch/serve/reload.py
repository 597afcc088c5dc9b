"""Versioned parameter pointer for serving (``ParamStore`` of
``sheeprl_tpu/serve/reload.py``).

The JAX package's ``CommitWatcher`` (hot reload on a new ``COMMIT``) is not
ported yet; the store keeps the same generation/step surface so that the
service and its stats read the same way.
"""

from __future__ import annotations

import threading
from typing import Any


class ParamStore:
    """Versioned, thread-safe pointer to the serving parameter subtree."""

    def __init__(self, params: Any, step: int = -1):
        self._lock = threading.Lock()
        self._params = params
        self._generation = 0
        self._step = int(step)

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

    def swap(self, params: Any, step: int) -> int:
        """Install a new (already device-resident) tree; returns the new
        generation.  The old tree stays alive until every in-flight dispatch
        holding its reference finishes — garbage collection IS the second
        half of the double buffer."""
        with self._lock:
            self._params = params
            self._step = int(step)
            self._generation += 1
            return self._generation
