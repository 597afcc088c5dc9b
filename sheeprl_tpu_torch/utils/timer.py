"""Named wall-clock timers (counterpart of ``sheeprl_tpu/utils/timer.py``).

Train loops wrap the env-interaction and train phases; at log time the
steps-per-second rates are derived and the timers reset.  CUDA work is
asynchronous, so a phase's time is its host time unless
``metric.sync_timers=True``, which synchronises the device at each phase
boundary.  The two phase timers every loop has are also the telemetry
spans ``rollout`` and ``update.dispatch`` (``telemetry/spans.py``).
"""

from __future__ import annotations

import time
from contextlib import ContextDecorator
from typing import Any, ClassVar, Dict

from sheeprl_tpu_torch.telemetry.spans import SPANS, TIMER_PHASES


class timer(ContextDecorator):
    disabled: ClassVar[bool] = False
    sync: ClassVar[bool] = False
    timers: ClassVar[Dict[str, float]] = {}

    def __init__(self, name: str):
        self.name = name

    @classmethod
    def configure(cls, metric_cfg: Any) -> None:
        """Apply the ``metric.*`` timing knobs (every train loop calls this)."""
        cls.disabled = bool(metric_cfg.get("disable_timer", False) or metric_cfg.get("log_level", 1) == 0)
        cls.sync = bool(metric_cfg.get("sync_timers", False))

    @staticmethod
    def _drain_device() -> None:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def __enter__(self) -> "timer":
        if timer.sync and not timer.disabled:
            timer._drain_device()
        # the phase-span bridge: independent of `disabled`, so spans (and
        # the trace scheduler's tick stream they drive) stay live at
        # metric.log_level=0
        phase = TIMER_PHASES.get(self.name)
        self._span = SPANS.push(phase) if phase is not None else None
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> bool:
        if self._span is not None:
            SPANS.pop(self._span)
        if not timer.disabled:
            if timer.sync:
                timer._drain_device()
            elapsed = time.perf_counter() - self._start
            timer.timers[self.name] = timer.timers.get(self.name, 0.0) + elapsed
        return False

    @classmethod
    def to_dict(cls, reset: bool = True) -> Dict[str, float]:
        """Seconds summed per timer name since the last reset."""
        out = dict(cls.timers)
        if reset:
            cls.timers = {}
        return out
