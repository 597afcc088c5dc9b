"""Which decoupled topology a run takes, the device split and the learner →
actor parameter broadcast (counterpart of ``sheeprl_tpu/parallel/topology.py``).

The port runs one process on one device.  Its topologies:

* ``pipelined`` (``auto`` and ``pipelined``): the single-controller loop, the
  update of one rollout overlapping the collection of the next, the player
  acting on weights one iteration (PPO) or ``algo.player.sync_every``
  windows (SAC) old;
* ``sebulba`` (``topology=sebulba``, or ``topology.actor_devices`` set): the
  actor/learner runtime of :mod:`sheeprl_tpu_torch.sebulba`.  On one device
  it is the JAX package's degenerate split: :meth:`DeviceTopology.from_config`
  gives both roles the one device and warns as JAX does.

``pod`` needs several processes and raises the JAX package's ``ValueError``;
a wanted split above one process (JAX's pod) raises, naming the ROADMAP item
that brings the layer above one device (ROADMAP.md, queue A item 5(b)).

:class:`ParamBroadcast` keeps JAX's versions, gate and metrics.  Where JAX
publishes immutable arrays, the port's optimizer writes its parameters in
place: :meth:`ParamBroadcast.publish` stages a copy on the learner's stream
behind the update and records an event; an actor installs that copy into its
own live tensors between two dispatches, on its own stream, after waiting on
the event (:meth:`StagedCopy.copy_into`), as ``serve/reload.py`` installs a
snapshot into a captured step.  The actors' captured graphs read only their
own tensors.
"""

from __future__ import annotations

import threading
import time
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch

from sheeprl_tpu_torch.resilience.faults import fault_point
from sheeprl_tpu_torch.telemetry.spans import span

POD_DEFERRED = (
    "the actor/learner split above one process (topology=pod, sheeprl_tpu/sebulba/pod.py) is not ported yet: "
    "the port runs one process (ROADMAP.md, queue A item 5(b))"
)


def topology_cfg(cfg: Any) -> Dict[str, Any]:
    """The ``topology`` config group as a plain dict (empty when absent)."""
    raw = cfg.get("topology") if hasattr(cfg, "get") else None
    return dict(raw) if raw else {}


def resolve_topology(cfg: Any, fabric: Any = None) -> str:
    """The decoupled topology of this run: ``"pipelined"`` or ``"sebulba"``
    (see the module's docstring for the cases that raise)."""
    topo = topology_cfg(cfg)
    name = str(topo.get("name", "auto")).lower()
    if name == "pipelined":
        return "pipelined"
    if name not in ("auto", "sebulba", "pod"):
        raise ValueError(f"topology.name must be auto|pipelined|sebulba|pod, got {name!r}")
    num_processes = int(getattr(fabric, "num_processes", 1) or 1)
    if name == "pod" and num_processes <= 1:
        raise ValueError(
            "topology=pod needs a multi-process fabric (fabric.distributed.*, "
            "or SHEEPRL_FAKE_DCN=N for the CI pod)"
        )
    wanted = name in ("sebulba", "pod") or topo.get("actor_devices") is not None
    if not wanted:
        return "pipelined"
    if num_processes > 1:
        raise NotImplementedError(POD_DEFERRED)
    return "sebulba"


@dataclass
class DeviceTopology:
    """The resolved actor/learner device split.  The port has one device, so
    both roles share it (``shared``), as in the JAX package's one-device
    mesh; ``learner_fabric`` is the run's fabric."""

    fabric: Any
    actor_devices: List[torch.device]
    learner_devices: List[torch.device]
    shared: bool = False

    @property
    def learner_fabric(self) -> Any:
        return self.fabric

    @property
    def num_actors(self) -> int:
        return len(self.actor_devices)

    @property
    def num_learners(self) -> int:
        return len(self.learner_devices)

    def describe(self) -> str:
        a = ", ".join(str(d) for d in self.actor_devices)
        l = ", ".join(str(d) for d in self.learner_devices)  # noqa: E741
        tag = " (shared device: degenerate split)" if self.shared else ""
        return f"sebulba topology{tag}: actors=[{a}] learners=[{l}]"

    @classmethod
    def from_config(cls, fabric: Any, cfg: Any) -> "DeviceTopology":
        """The one device playing both roles, with the JAX package's warning."""
        warnings.warn(
            "topology=sebulba on a 1-device mesh: actor and learner "
            "groups share the device (no real split; use >= 2 devices "
            "for the actor/learner overlap)",
            RuntimeWarning,
        )
        return cls(fabric, [fabric.device], [fabric.device], shared=True)


class StalenessExceeded(RuntimeError):
    """The learner waited past its deadline for actors to pick up fresh
    params (``topology.max_staleness`` gate)."""


def named_tensors(params: Any) -> Dict[str, torch.Tensor]:
    """A module's parameters and buffers, or a dict of tensors, by name."""
    if isinstance(params, torch.nn.Module):
        return {k: t.detach() for k, t in params.state_dict().items()}
    return {k: t.detach() for k, t in params.items()}


class StagedCopy:
    """One published version of the actor's tensors on one actor device: a
    copy made on the publishing thread's stream, behind the update, and the
    event that marks it done."""

    def __init__(self, tensors: Dict[str, torch.Tensor], device: torch.device):
        self.tensors = {k: t.to(device, copy=True) for k, t in tensors.items()}
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(device))

    def copy_into(self, live: Dict[str, torch.Tensor]) -> None:
        """Copy into ``live`` (same names) on the calling thread's current
        stream, after the copy it was staged by.  The staged tensors are
        marked as used on that stream, so the allocator keeps their memory
        until the copy has read it."""
        names = list(live)
        src = [self.tensors[k] for k in names]
        if self.event is not None:
            stream = torch.cuda.current_stream(src[0].device)
            stream.wait_event(self.event)
            for t in src:
                t.record_stream(stream)
        with torch.no_grad():
            torch._foreach_copy_([live[k] for k in names], src)


class ParamBroadcast:
    """Learner → actor parameter broadcast with a bounded, observable
    staleness contract (JAX's, see the module's docstring).

    :meth:`publish` stages a copy of ``extract(params)`` per actor device and
    stamps it with a version; :meth:`fetch` hands an actor the newest copy;
    :meth:`gate` blocks the learner until every actor has fetched a version
    within ``max_staleness`` of the current one."""

    def __init__(
        self,
        fabric: Any,
        actor_devices: List[Any],
        extract: Callable[[Any], Any] = lambda p: p,
        max_staleness: int = 2,
        gate_timeout_s: float = 300.0,
    ):
        self.fabric = fabric
        self.actor_devices = [torch.device(d) for d in actor_devices]
        self.extract = extract
        self.max_staleness = int(max_staleness)
        self.gate_timeout_s = float(gate_timeout_s)
        self._lock = threading.Lock()
        self._fetched = threading.Condition(self._lock)
        self._version = 0
        self._params: List[Optional[StagedCopy]] = [None] * len(self.actor_devices)
        self._fetched_version = [0] * len(self.actor_devices)
        # observability (read under the lock, flushed as Sebulba/* metrics)
        self.publishes = 0
        self.gate_wait_s = 0.0
        self.staleness_sum = 0
        self.staleness_max = 0
        self.fetches = 0

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def publish(self, params: Any, version: Optional[int] = None) -> int:
        """Stage the actor's share of ``params`` for every actor device and
        stamp it with ``version`` (the next integer by default)."""
        with span("param.broadcast"):
            fault_point("fabric.copy_to")
            sub = named_tensors(self.extract(params))
            copies = [StagedCopy(sub, d) for d in self.actor_devices]
        with self._lock:
            first = self.publishes == 0
            self._version = int(version) if version is not None else self._version + 1
            if first:
                # the FIRST publish defines the baseline (a resumed run
                # publishes its checkpointed version): staleness measures
                # lag, not the absolute resume offset
                self._fetched_version = [self._version] * len(self.actor_devices)
            self._params = copies
            self.publishes += 1
            self._fetched.notify_all()
            return self._version

    def fetch(self, actor_index: int) -> tuple:
        """Newest published ``(StagedCopy, version)`` for one actor; records
        the fetch for the gate and the metrics.  ``(None, 0)`` before the
        first publish."""
        with self._lock:
            params = self._params[actor_index]
            version = self._version
            lag = version - self._fetched_version[actor_index]
            self._fetched_version[actor_index] = version
            self.fetches += 1
            self.staleness_sum += lag
            self.staleness_max = max(self.staleness_max, lag)
            self._fetched.notify_all()
            return params, version

    def staleness(self, actor_index: int) -> int:
        """How many published versions behind this actor's last fetch is."""
        with self._lock:
            return self._version - self._fetched_version[actor_index]

    def gate(self, timeout_s: Optional[float] = None) -> float:
        """Block until every actor's last fetch is within ``max_staleness``
        of the current version; returns the seconds waited, raises
        :class:`StalenessExceeded` past the deadline."""
        deadline = time.monotonic() + (self.gate_timeout_s if timeout_s is None else float(timeout_s))
        t0 = time.monotonic()
        with self._lock:
            while self._version - min(self._fetched_version) > self.max_staleness:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    lags = [self._version - f for f in self._fetched_version]
                    raise StalenessExceeded(
                        f"actors still {lags} versions behind after "
                        f"{self.gate_timeout_s}s (max_staleness="
                        f"{self.max_staleness})"
                    )
                self._fetched.wait(remaining)
        waited = time.monotonic() - t0
        with self._lock:
            self.gate_wait_s += waited
        return waited

    def metrics(self) -> Dict[str, float]:
        with self._lock:
            return {
                "Sebulba/param_version": float(self._version),
                "Sebulba/param_staleness_max": float(self.staleness_max),
                "Sebulba/param_staleness_avg": (self.staleness_sum / self.fetches if self.fetches else 0.0),
                "Sebulba/param_gate_wait_s": float(self.gate_wait_s),
            }
