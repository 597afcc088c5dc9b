"""The port's resilience layer (counterpart of ``sheeprl_tpu/resilience``):
the seeded fault-injection engine (``faults``), the recovery primitives
(``retry``: jittered-backoff :func:`retry`, the :class:`Watchdog` and the
:class:`CircuitBreaker`), and the training-health sentinels (``health``),
all counting into ``telemetry.monitors.RESILIENCE_MONITOR``."""

from sheeprl_tpu_torch.resilience.faults import (
    ENV_VAR,
    KNOWN_SITES,
    TRACE_SITES,
    UNPORTED_SITES,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    active_plan,
    clear_plan,
    fault_bytes,
    fault_point,
    fault_rows,
    install_from_config,
    install_from_env,
    install_plan,
)
from sheeprl_tpu_torch.resilience.health import DivergenceError, HealthSentinel, HealthState
from sheeprl_tpu_torch.resilience.retry import CircuitBreaker, Watchdog, retry

__all__ = [
    "ENV_VAR",
    "KNOWN_SITES",
    "TRACE_SITES",
    "UNPORTED_SITES",
    "CircuitBreaker",
    "DivergenceError",
    "FaultPlan",
    "FaultSpec",
    "HealthSentinel",
    "HealthState",
    "InjectedFault",
    "Watchdog",
    "active_plan",
    "clear_plan",
    "fault_bytes",
    "fault_point",
    "fault_rows",
    "install_from_config",
    "install_from_env",
    "install_plan",
    "retry",
]
