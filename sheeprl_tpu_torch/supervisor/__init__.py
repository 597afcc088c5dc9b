"""Self-healing run supervision of one child process on one device
(counterpart of ``sheeprl_tpu/supervisor/``).

``supervise`` owns the process-level loop — launch the training CLI as a
child, heartbeat it through the introspection endpoint, restart transient
failures from the last committed checkpoint under a budget and backoff;
``classify`` owns the transient-vs-deterministic triage of each exit (the
crash-loop circuit breaker's evidence).  The in-loop half — the health
guard that skips poisoned updates and detects divergence inside the run —
is :mod:`sheeprl_tpu_torch.resilience.health`.  The pod supervisor over
several processes is not ported (ROADMAP.md, queue A item 5(b)):
:func:`resolve_supervisor` raises for a pod-shaped invocation.
"""

from sheeprl_tpu_torch.supervisor.classify import (
    DETERMINISTIC,
    DIVERGED,
    PREEMPTED,
    SUCCESS,
    TRANSIENT,
    Verdict,
    classify,
    crash_error,
    load_postmortem,
)
from sheeprl_tpu_torch.supervisor.supervise import (
    EXIT_BREAKER,
    EXIT_BUDGET,
    EXIT_OK,
    Supervisor,
    main,
    resolve_supervisor,
)

__all__ = [
    "DETERMINISTIC",
    "DIVERGED",
    "EXIT_BREAKER",
    "EXIT_BUDGET",
    "EXIT_OK",
    "PREEMPTED",
    "SUCCESS",
    "TRANSIENT",
    "Supervisor",
    "Verdict",
    "classify",
    "crash_error",
    "load_postmortem",
    "main",
    "resolve_supervisor",
]
