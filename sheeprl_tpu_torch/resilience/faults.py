"""Seeded, deterministic fault-injection engine (counterpart of
``sheeprl_tpu/resilience/faults.py``, copied: the module has no JAX in it).

Faults are described by a :class:`FaultPlan`: a list of :class:`FaultSpec`
entries, each naming an **injection site** (a string like ``env.step`` —
the full registry is :data:`KNOWN_SITES`), a **schedule** (fire at the
site's N-th invocation, every K-th, or with seeded probability ``p``) and a
**fault kind**:

* ``raise``   — raise :class:`InjectedFault` (or a builtin exception),
* ``hang``    — sleep ``seconds`` (simulates a wedged worker / dead disk),
* ``latency`` — sleep ``seconds`` then continue (slow link, GC pause),
* ``corrupt`` — flip bytes of the payload passing through the site,
* ``truncate``— drop the tail of the payload passing through the site,
* ``nonfinite`` / ``divergence`` — at ``update.grads`` only, resolved by the
  health guard into the train window (``resilience/health.py``).

The plan comes from the ``fault_injection`` config group
(``fault_injection.enabled=true fault_injection.plan='[...]'``) or from the
``SHEEPRL_FAULT_PLAN`` environment variable (a JSON list of spec dicts — the
spelling that crosses into subprocesses), installed by the entry points
(``cli.run``, ``cli.serve``); unlike the JAX module, importing this one
installs nothing.

The port's sites: ``env.step`` / ``env.reset`` (``envs/wrappers.py::
FaultInjectionEnv``), ``checkpoint.write_shard`` / ``checkpoint.commit``
(``checkpoint/protocol.py``), ``serve.http`` (``serve/server.py``),
``serve.router`` (the fleet router's own request handling) and
``serve.replica`` (each router→replica leg; ``serve/fleet/router.py``),
``fabric.copy_to`` (``fabric.py::PlayerSync``, the player's weight copy),
``replay.spill`` (``data/device_replay.py::HostSpill``) and
``update.grads`` (``resilience/health.py``).  A plan at a site whose module
the port does not have yet (:data:`UNPORTED_SITES`) is refused when it is
installed, naming the ROADMAP item that brings the module.

The disabled path is one module-global ``is None`` test per hook:
:func:`install_plan` stores ``None`` for a plan with no specs.

Determinism: ``at``/``every`` schedules count the site's invocations in the
current process; ``p`` schedules draw from a per-spec ``random.Random``
seeded with ``seed ^ crc32(site)``, so a run with the same plan and seed
injects the same fault sequence.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence

#: The named injection sites wired through the runtime.  A spec naming an
#: unknown site is rejected at plan-build time (typos must not silently
#: disarm a chaos drill).
KNOWN_SITES = (
    "env.step",
    "env.reset",
    "checkpoint.write_shard",
    "checkpoint.commit",
    "serve.http",
    "serve.router",
    "serve.replica",
    "fabric.copy_to",
    "replay.spill",
    "sebulba.env_worker",
    "sebulba.traj_queue",
    "update.grads",
    "dcn.broadcast",
    "dcn.traj",
)

KINDS = ("raise", "hang", "latency", "corrupt", "truncate", "nonfinite", "divergence")

#: Sites whose hook passes a byte payload (``fault_bytes``) — the only
#: legal targets for ``corrupt`` specs.  The two ``dcn.*`` sites sit on
#: the cross-host wire AFTER the CRC stamp: ``corrupt``/``truncate``
#: there model a damaged DCN payload, which the receiving cell's CRC
#: check must reject (torn-segment / torn-broadcast contract).
BYTE_SITES = ("checkpoint.write_shard", "dcn.broadcast", "dcn.traj")

#: Sites whose hook passes replay rows (``fault_rows``): ``truncate`` there
#: tail-halves the queued rows (a torn spill write / a torn trajectory
#: segment), not a byte payload.
ROW_SITES = ("replay.spill", "sebulba.traj_queue")

#: Sites whose faults are compiled INTO the train trace by the health
#: sentinels (``resilience/health.py``) rather than polled host-side.
#: ``nonfinite`` poisons the update's params/loss with NaN (what a NaN
#: gradient does), ``divergence`` multiplies the loss the spike detector
#: sees — both deterministically, at the spec's ``at``/``every`` guarded
#: dispatch number, with ZERO per-step host involvement (the schedule is
#: resolved at trace-build time, so the guarded executable stays one
#: program and the transfer guard sees no extra H2D).  ``p`` schedules are
#: rejected here: a host RNG draw per dispatch would need a per-step
#: transfer.
TRACE_SITES = ("update.grads",)
TRACE_KINDS = ("nonfinite", "divergence")

ENV_VAR = "SHEEPRL_FAULT_PLAN"

#: Sites of the JAX package whose module the port does not have yet, and the
#: ROADMAP item that brings it.
UNPORTED_SITES = {
    "sebulba.env_worker": "sebulba/, ROADMAP.md, queue A item 5(b)",
    "sebulba.traj_queue": "sebulba/, ROADMAP.md, queue A item 5(b)",
    "dcn.broadcast": "sebulba/transport.py, ROADMAP.md, queue A item 5(b)",
    "dcn.traj": "sebulba/transport.py, ROADMAP.md, queue A item 5(b)",
}


class InjectedFault(RuntimeError):
    """The default exception raised by a ``kind: raise`` fault."""


@dataclass
class FaultSpec:
    """One fault: where, when, and what."""

    site: str
    kind: str = "raise"
    #: fire exactly at the site's N-th invocation (1-based)
    at: Optional[int] = None
    #: fire at every K-th invocation
    every: Optional[int] = None
    #: fire with this seeded probability per invocation
    p: Optional[float] = None
    #: hang/latency duration
    seconds: float = 5.0
    #: stop firing after this many injections (None = unlimited)
    max_fires: Optional[int] = None
    #: per-spec RNG seed override (defaults to the plan seed)
    seed: Optional[int] = None
    #: exception message for ``raise`` kinds
    message: str = ""
    #: builtin exception class name for ``raise`` kinds (default
    #: :class:`InjectedFault`) — e.g. ``OSError`` to look transient to the
    #: retry layer, ``ConnectionError`` for the serve client
    exception: str = ""

    # runtime state (not part of the spec identity)
    _calls: int = field(default=0, repr=False, compare=False)
    _fires: int = field(default=0, repr=False, compare=False)
    _rng: Any = field(default=None, repr=False, compare=False)

    def validate(self) -> "FaultSpec":
        if self.site not in KNOWN_SITES:
            raise ValueError(
                f"unknown fault site '{self.site}' (known: {', '.join(KNOWN_SITES)})"
            )
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind '{self.kind}' (known: {', '.join(KINDS)})")
        if (self.kind in TRACE_KINDS) != (self.site in TRACE_SITES):
            # same build-time philosophy as the corrupt/truncate checks: a
            # trace-kind at a host site (or a host kind at the trace site)
            # validates and then silently never acts — reject it loudly
            raise ValueError(
                f"fault kind '{self.kind}' and site '{self.site}' do not match: "
                f"kinds {TRACE_KINDS} act only at the in-trace sites "
                f"{TRACE_SITES} (and those sites accept only them)"
            )
        if self.site in TRACE_SITES:
            if self.p is not None:
                raise ValueError(
                    f"fault site '{self.site}' is compiled into the train trace "
                    "and only supports deterministic at=/every= schedules, not p="
                )
        payload_sites = BYTE_SITES + ROW_SITES
        if self.kind == "corrupt" and self.site not in BYTE_SITES:
            # a byte fault at a value site would validate and then silently
            # never act — exactly the "drill runs green while injecting
            # nothing" failure the build-time checks exist to prevent
            raise ValueError(
                f"fault kind '{self.kind}' only acts at byte-payload sites "
                f"({', '.join(BYTE_SITES)}), not '{self.site}'"
            )
        if self.kind == "truncate" and self.site not in payload_sites:
            raise ValueError(
                f"fault kind 'truncate' only acts at payload sites "
                f"({', '.join(payload_sites)}), not '{self.site}'"
            )
        if self.at is None and self.every is None and self.p is None:
            raise ValueError(
                f"fault spec for '{self.site}' has no schedule: set at=, every= or p="
            )
        if self.p is not None and not (0.0 <= float(self.p) <= 1.0):
            raise ValueError(f"fault p={self.p} is not a probability")
        self.make_exception()  # typo'd exception names fail at build time
        return self

    def make_exception(self) -> BaseException:
        if not self.exception:
            return InjectedFault(self.message or f"injected fault at {self.site}")
        import builtins

        exc_type = getattr(builtins, self.exception, None)
        if not (isinstance(exc_type, type) and issubclass(exc_type, BaseException)):
            raise ValueError(f"fault exception '{self.exception}' is not a builtin exception")
        return exc_type(self.message or f"injected {self.exception} at {self.site}")

    def bind(self, plan_seed: int) -> "FaultSpec":
        import random

        seed = self.seed if self.seed is not None else plan_seed
        self._rng = random.Random((int(seed) ^ (zlib.crc32(self.site.encode()) & 0x7FFFFFFF)))
        return self

    def should_fire(self) -> bool:
        """Advance this spec's invocation counter and decide (thread-safe
        under the plan lock, see :meth:`FaultPlan.poll`)."""
        self._calls += 1
        if self.max_fires is not None and self._fires >= self.max_fires:
            return False
        fire = False
        if self.at is not None and self._calls == int(self.at):
            fire = True
        if not fire and self.every is not None and int(self.every) > 0:
            fire = self._calls % int(self.every) == 0
        if not fire and self.p is not None:
            fire = self._rng.random() < float(self.p)
        if fire:
            self._fires += 1
        return fire


def _spec_from_mapping(raw: Mapping[str, Any]) -> FaultSpec:
    known = {f for f in FaultSpec.__dataclass_fields__ if not f.startswith("_")}
    unknown = set(raw) - known
    if unknown:
        raise ValueError(f"unknown fault spec fields {sorted(unknown)} in {dict(raw)}")
    return FaultSpec(**{k: raw[k] for k in raw}).validate()


class FaultPlan:
    """A validated, seeded set of fault specs, indexed by site."""

    def __init__(self, specs: Iterable[FaultSpec], seed: int = 0):
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._by_site: Dict[str, List[FaultSpec]] = {}
        for spec in specs:
            spec.validate().bind(self.seed)
            self._by_site.setdefault(spec.site, []).append(spec)

    def __bool__(self) -> bool:
        return bool(self._by_site)

    @property
    def sites(self) -> List[str]:
        return sorted(self._by_site)

    def targets(self, prefix: str) -> bool:
        """Does any spec target a site under ``prefix`` (e.g. ``"env."``)?"""
        return any(s.startswith(prefix) for s in self._by_site)

    @classmethod
    def from_specs(
        cls, raw: Sequence[Mapping[str, Any]], seed: int = 0
    ) -> "FaultPlan":
        return cls([_spec_from_mapping(r) for r in raw], seed=seed)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        """Parse the ``SHEEPRL_FAULT_PLAN`` spelling: either a bare JSON list
        of spec dicts, or ``{"seed": n, "plan": [...]}``."""
        data = json.loads(text)
        if isinstance(data, Mapping):
            return cls.from_specs(data.get("plan", []), seed=int(data.get("seed", 0) or 0))
        return cls.from_specs(data)

    def to_json(self) -> str:
        """Serialize for handing to a subprocess via ``SHEEPRL_FAULT_PLAN``."""
        out = []
        for specs in self._by_site.values():
            for s in specs:
                entry = {
                    k: getattr(s, k)
                    for k in (
                        "site", "kind", "at", "every", "p", "seconds", "max_fires",
                        "seed", "message", "exception",
                    )
                    if getattr(s, k) not in (None, "")
                }
                out.append(entry)
        return json.dumps({"seed": self.seed, "plan": out})

    # -- firing --------------------------------------------------------------
    def poll(self, site: str) -> List[FaultSpec]:
        """All specs of ``site`` that fire at this invocation."""
        specs = self._by_site.get(site)
        if not specs:
            return []
        with self._lock:
            return [s for s in specs if s.should_fire()]

    def specs_for(self, site: str) -> List[FaultSpec]:
        """Read-only view of the specs targeting ``site`` — NO counter
        advance.  The health sentinels use this at trace-build time to
        compile ``update.grads`` schedules into the guarded executable."""
        return list(self._by_site.get(site, ()))


# -- the process-global active plan ------------------------------------------
#
# ``_PLAN is None`` IS the disabled fast path: install_plan() of an empty
# plan stores None, so every instrumented call site pays exactly one global
# load + identity test when fault injection is off.
_PLAN: Optional[FaultPlan] = None


def active_plan() -> Optional[FaultPlan]:
    return _PLAN


def install_plan(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install (or clear, with ``None``/empty) the process-global plan.
    Raises NotImplementedError for a plan at a site the port does not have
    (:data:`UNPORTED_SITES`): such a drill would inject nothing."""
    global _PLAN
    unported = [s for s in (plan.sites if plan else ()) if s in UNPORTED_SITES]
    if unported:
        raise NotImplementedError(
            "fault plan at " + ", ".join(f"{s} ({UNPORTED_SITES[s]})" for s in unported)
            + ": the port does not have that module yet, so the plan would inject nothing")
    _PLAN = plan if plan else None
    return _PLAN


def clear_plan() -> None:
    install_plan(None)


def install_from_env() -> Optional[FaultPlan]:
    """(Re)install from ``SHEEPRL_FAULT_PLAN`` if set; returns the plan."""
    raw = os.environ.get(ENV_VAR, "").strip()
    if not raw:
        return _PLAN
    return install_plan(FaultPlan.from_json(raw))


def install_from_config(cfg: Any) -> Optional[FaultPlan]:
    """Install from the ``fault_injection`` config group (CLI entrypoints
    call this after compose).  The ``SHEEPRL_FAULT_PLAN`` env var wins when
    both are set — it is how drills reach into subprocesses."""
    if os.environ.get(ENV_VAR, "").strip():
        return install_from_env()
    fi = cfg.get("fault_injection") if hasattr(cfg, "get") else None
    if not fi or not fi.get("enabled", False):
        return install_plan(None)
    seed = fi.get("seed")
    if seed is None:
        seed = cfg.get("seed", 0) if hasattr(cfg, "get") else 0
    return install_plan(FaultPlan.from_specs(fi.get("plan") or [], seed=int(seed or 0)))


# -- hot-path hooks -----------------------------------------------------------
def fault_point(site: str) -> None:
    """Raise / hang / delay if the active plan fires at ``site``.

    The disabled path is ONE global load + ``is None`` test — safe to call
    per env step / per HTTP request / per device transfer.
    """
    if _PLAN is None:
        return
    for spec in _PLAN.poll(site):
        # corrupt/truncate specs are byte transforms: they only act through
        # fault_bytes — at a non-payload site they are inert (not recorded)
        if spec.kind in ("hang", "latency"):
            _record_injection(site, spec.kind)
            time.sleep(float(spec.seconds))
        elif spec.kind == "raise":
            _record_injection(site, spec.kind)
            raise spec.make_exception()


def fault_bytes(site: str, payload: bytes) -> bytes:
    """Pass ``payload`` through the plan's corrupt/truncate specs for
    ``site`` (also honors raise/hang/latency specs, so one call
    instruments a write site completely)."""
    if _PLAN is None:
        return payload
    for spec in _PLAN.poll(site):
        _record_injection(site, spec.kind)
        if spec.kind in ("hang", "latency"):
            time.sleep(float(spec.seconds))
        elif spec.kind == "raise":
            raise spec.make_exception()
        elif spec.kind == "truncate":
            payload = payload[: max(0, len(payload) // 2)]
        elif spec.kind == "corrupt":
            flip = max(1, len(payload) // 2)
            payload = payload[:flip] + bytes(b ^ 0xFF for b in payload[flip : flip + 8]) + payload[flip + 8 :]
    return payload


def fault_rows(site: str, rows: "dict") -> "dict":
    """Pass a dict of ``(T, B, *)`` replay rows through the plan's specs for
    ``site`` (the ``replay.spill`` hook): latency/hang sleep, raise raises,
    truncate drops the tail half of the time axis (a torn spill write —
    the spill worker persists fewer rows than the device ring took)."""
    if _PLAN is None:
        return rows
    for spec in _PLAN.poll(site):
        _record_injection(site, spec.kind)
        if spec.kind in ("hang", "latency"):
            time.sleep(float(spec.seconds))
        elif spec.kind == "raise":
            raise spec.make_exception()
        elif spec.kind == "truncate":
            rows = {k: v[: max(1, v.shape[0] // 2)] for k, v in rows.items()}
    return rows


def _record_injection(site: str, kind: str) -> None:
    from sheeprl_tpu_torch.telemetry.monitors import RESILIENCE_MONITOR

    RESILIENCE_MONITOR.record_injection(site, kind)
