"""Monitor shims (counterpart of ``sheeprl_tpu/utils/profiler.py``).

The compile and resilience monitors live in ``telemetry/monitors.py``;
these names are the same objects, so ``from sheeprl_tpu_torch.utils.profiler
import COMPILE_MONITOR`` reads as it does in the JAX package.  The JAX module's
``ProfilerGate`` (a ``jax.profiler`` window armed by ``metric.profiler``)
is not ported yet: ``metric.profiler`` is named by
``warn_unacted_settings`` (ROADMAP.md, queue A item 6).
"""

from sheeprl_tpu_torch.telemetry.monitors import (  # noqa: F401  (shims)
    COMPILE_MONITOR,
    RESILIENCE_MONITOR,
    CompileMonitor,
    RecompileLimitExceeded,
    ResilienceMonitor,
)
