"""Profiler gating for train loops + monitor shims (counterpart of
``sheeprl_tpu/utils/profiler.py``).

The compile, checkpoint and resilience monitors live in
``telemetry/monitors.py``; the names below are the same objects, so
``from sheeprl_tpu_torch.utils.profiler import COMPILE_MONITOR`` reads as it
does in the JAX package.

:class:`ProfilerGate` is the config-armed ``torch.profiler`` window around
a fixed update range (``metric.profiler.start_update`` /
``stop_update``), written as a Chrome trace to
``<log_dir>/profiler/trace.json``.  For windows on a live run (update
numbers, ``SHEEPRL_TRACE_AT``, SIGUSR1) use ``telemetry.trace_at``
(``telemetry/tracer.py``).
"""

from __future__ import annotations

import os
from typing import Any

from sheeprl_tpu_torch.telemetry.monitors import (  # noqa: F401  (shims)
    CHECKPOINT_MONITOR,
    COMPILE_MONITOR,
    RESILIENCE_MONITOR,
    CheckpointMonitor,
    CompileMonitor,
    RecompileLimitExceeded,
    ResilienceMonitor,
)
from sheeprl_tpu_torch.telemetry.tracer import TRACE_FILE


class ProfilerGate:
    """Start/stop ``torch.profiler`` around a window of training updates:
    CPU activity always, CUDA activity when CUDA is available."""

    def __init__(self, cfg: Any, log_dir: str):
        pcfg = (cfg.metric.get("profiler", {}) or {}) if "metric" in cfg else {}
        self.enabled = bool(pcfg.get("enabled", False))
        self.start_update = int(pcfg.get("start_update", 10))
        self.stop_update = int(pcfg.get("stop_update", 12))
        self.trace_dir = os.path.join(log_dir, "profiler")
        self._prof: Any = None

    def step(self, update: int) -> None:
        """Call once per training update with the loop counter."""
        if not self.enabled:
            return
        if self._prof is None and self.start_update <= update < self.stop_update:
            import torch
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(self.trace_dir, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()
        elif self._prof is not None and update >= self.stop_update:
            self.close()

    def close(self) -> None:
        if self._prof is not None:
            prof, self._prof = self._prof, None
            prof.stop()
            prof.export_chrome_trace(os.path.join(self.trace_dir, TRACE_FILE))
