"""Failure classification: transient infra vs deterministic crash (a copy of
``sheeprl_tpu/supervisor/classify.py``, which imports no JAX).

The supervisor's one hard rule: **never restart-loop a deterministic
failure**.  A child that dies the same way at the same step twice will die
a third time — restarting it burns the restart budget, the accelerator
reservation, and the on-call's patience while hiding the actual bug.
Everything else (SIGKILL'd by the scheduler, a wedged host, a transient
storage error, a preemption, a first-occurrence exception) is worth one
resume-from-checkpoint attempt under the budget.

Classification evidence, in order of trust:

1. the **hang verdict** the supervisor itself reached (its heartbeat
   watchdog killed the child) — the exit status is then meaningless (a
   SIGTERM'd child often exits 0 through its preemption save);
2. the **exit status**: 0 = success; killed by a signal = infra;
3. the **postmortem** (``postmortem.json``, written by the flight recorder
   of :mod:`sheeprl_tpu_torch.telemetry.recorder`): its ``reason`` and,
   for exceptions, a *fatal signature* ``(error, last_step)`` — the same
   signature twice in a row opens the circuit breaker.

A missing or malformed postmortem is itself a signal the child died hard
(OOM-killer, segfault before the dump) — treated as transient, bounded by
the restart budget.
"""

from __future__ import annotations

import json
import signal as _signal
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

#: classification kinds
SUCCESS = "success"
TRANSIENT = "transient"
DETERMINISTIC = "deterministic"
PREEMPTED = "preempted"
DIVERGED = "diverged"


@dataclass
class Verdict:
    """One episode's classification."""

    kind: str  # SUCCESS | TRANSIENT | DETERMINISTIC | PREEMPTED | DIVERGED
    reason: str  # human-readable one-liner for the audit log
    #: fatal signature for breaker matching — (error, last_step) for
    #: exceptions, ("hang", last_step) for watchdog kills, None when the
    #: failure mode cannot be deterministic (signals, missing postmortem)
    signature: Optional[Tuple[str, Any]] = None
    #: free-form evidence forwarded into supervisor_log.jsonl
    detail: Dict[str, Any] = field(default_factory=dict)

    @property
    def restartable(self) -> bool:
        return self.kind in (TRANSIENT, PREEMPTED, DIVERGED)


def _signal_name(returncode: int) -> str:
    try:
        return _signal.Signals(-returncode).name
    except (ValueError, OverflowError):
        return f"signal {-returncode}"


def load_postmortem(path: Optional[str]) -> Optional[Dict[str, Any]]:
    """Parse a postmortem.json; None when absent/undecodable/not ours."""
    if not path:
        return None
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or not str(doc.get("schema", "")).startswith("sheeprl.postmortem/"):
        return None
    return doc


def crash_error(postmortem: Dict[str, Any]) -> Optional[str]:
    """The newest ``crash`` event's error string (the exception that ended
    the run, recorded by ``cli.run``'s crash path)."""
    events = postmortem.get("events")
    if not isinstance(events, list):
        return None
    for evt in reversed(events):
        if isinstance(evt, dict) and evt.get("kind") == "crash":
            err = evt.get("error")
            return str(err) if err is not None else None
    return None


def classify(
    returncode: Optional[int],
    postmortem: Optional[Dict[str, Any]],
    *,
    hung: bool = False,
) -> Verdict:
    """Classify one finished episode (see module docstring for the rules).

    ``postmortem`` is the already-parsed document (or None); ``hung`` means
    the supervisor's own watchdog killed the child, which overrides the
    exit status.  Breaker accounting — "same signature twice" — is the
    caller's job: this function only derives the signature.
    """
    last_step = postmortem.get("last_step") if isinstance(postmortem, dict) else None

    if hung:
        return Verdict(
            TRANSIENT,
            "hang: heartbeat/progress watchdog killed the child",
            signature=("hang", last_step),
            detail={"last_step": last_step},
        )

    # BEFORE the rc==0 success branch: a preempted child exits 0 — the
    # latch breaks the loop and cli.run returns normally after the final
    # committed save — but it did NOT finish its configured steps.  The
    # preemption postmortem (only written when the latch fired) is the
    # tell; a genuinely completed run leaves no such document.
    if isinstance(postmortem, dict) and str(postmortem.get("reason", "")) == "preemption":
        return Verdict(
            PREEMPTED,
            "preemption latch honored (final committed save)",
            signature=None,
            detail={"last_step": last_step},
        )

    if returncode == 0:
        return Verdict(SUCCESS, "clean exit (rc=0)")

    if returncode is not None and returncode < 0:
        # killed by a signal the child never handled (kill -9, OOM, segv):
        # infrastructure, by definition not reproducible from the program's
        # own state — restart under the budget, never the breaker
        return Verdict(
            TRANSIENT,
            f"killed by {_signal_name(returncode)}",
            signature=None,
            detail={"last_step": last_step},
        )

    if postmortem is None:
        return Verdict(
            TRANSIENT,
            f"nonzero exit (rc={returncode}) with missing/malformed postmortem",
            signature=None,
        )

    reason = str(postmortem.get("reason", ""))
    error = crash_error(postmortem) or f"rc={returncode}, reason={reason or 'unknown'}"
    if "DivergenceError" in error:
        # the health sentinels surfaced divergence: restarting with
        # resume_from=auto IS the rollback-to-last-committed-checkpoint —
        # but repeated divergence at the same step is deterministic, so it
        # carries a signature for the breaker like any other crash
        return Verdict(
            DIVERGED,
            f"training diverged: {error}",
            signature=(error, last_step),
            detail={"last_step": last_step},
        )

    return Verdict(
        TRANSIENT,
        f"crash: {error}",
        signature=(error, last_step),
        detail={"last_step": last_step, "reason": reason},
    )
