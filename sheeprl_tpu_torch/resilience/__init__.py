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

#: imported at first use: ``health`` imports torch, which an env worker
#: process (``utils/env.py``, through ``faults``) does without
_LAZY = {"DivergenceError": "health", "HealthSentinel": "health", "HealthState": "health",
         "CircuitBreaker": "retry", "Watchdog": "retry", "retry": "retry"}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f"sheeprl_tpu_torch.resilience.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

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
