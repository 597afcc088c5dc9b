"""Preemption (SIGTERM/SIGINT) handling for long training runs
(counterpart of ``sheeprl_tpu/checkpoint/preemption.py``, copied: the
module has no JAX in it).

A preempted machine gets SIGTERM and a grace window.  The guard turns the
first signal into a flag that the train loops read at their checkpoint
point: they make one final synchronous committed save and exit cleanly,
instead of dying mid-write.  The handler only sets the flag, so a signal
that lands while a captured CUDA graph replays interrupts nothing: the
loop reaches its checkpoint point after the window, and the save copies
the state to the host only once the device's queued work is done.  A
second signal restores the previous disposition and re-delivers itself, so
a stuck save can still be killed.

Installed by ``CheckpointManager.should_save`` when
``checkpoint.save_on_preemption`` is set, on the main thread only (CPython
allows ``signal.signal`` there alone; a loop run off the main thread gets
no graceful preemption).
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Any, Dict, Optional


class PreemptionGuard:
    """Process-wide latch flipped by SIGTERM/SIGINT."""

    def __init__(self) -> None:
        self._event = threading.Event()
        self._signum: Optional[int] = None
        self._previous: Dict[int, Any] = {}
        self._installed = False

    # -- installation --------------------------------------------------------
    def install(self) -> bool:
        """Install handlers for SIGTERM and SIGINT.  Returns False when not
        possible (non-main thread) — the run then simply has no graceful
        preemption, same as before this subsystem."""
        if self._installed:
            return True
        if threading.current_thread() is not threading.main_thread():
            return False
        try:
            for signum in (signal.SIGTERM, signal.SIGINT):
                self._previous[signum] = signal.signal(signum, self._handle)
        except (ValueError, OSError):
            self._restore()
            return False
        self._installed = True
        return True

    def _restore(self) -> None:
        for signum, prev in self._previous.items():
            try:
                signal.signal(signum, prev)
            except (ValueError, OSError):
                pass
        self._previous.clear()
        self._installed = False

    def _handle(self, signum: int, frame: Any) -> None:
        if self._event.is_set():
            # second signal: the graceful path is stuck — restore defaults
            # and re-deliver so the process actually dies
            self._restore()
            os.kill(os.getpid(), signum)
            return
        self._signum = signum
        self._event.set()

    # -- queries -------------------------------------------------------------
    def requested(self) -> bool:
        return self._event.is_set()

    @property
    def signal_name(self) -> Optional[str]:
        if self._signum is None:
            return None
        try:
            return signal.Signals(self._signum).name
        except ValueError:
            return str(self._signum)

    def clear_latch(self) -> None:
        """Clear a latched signal WITHOUT uninstalling handlers.  Called at
        the start of every ``cli.run``: a preemption latched during a
        previous run in the same interpreter (exploration→finetuning
        chains, notebooks) was already honored by that run's final save —
        the next run must start un-preempted, not exit after one update."""
        self._event.clear()
        self._signum = None

    def reset(self) -> None:
        """Clear the latch and uninstall (tests / sequential runs)."""
        self.clear_latch()
        self._restore()


#: The process-global guard; the checkpoint manager installs it, train loops poll it.
PREEMPTION_GUARD = PreemptionGuard()


def install_preemption_handler() -> bool:
    return PREEMPTION_GUARD.install()


def preemption_requested() -> bool:
    return PREEMPTION_GUARD.requested()
