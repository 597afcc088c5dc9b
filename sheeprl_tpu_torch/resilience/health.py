"""Training-health sentinels: the non-finite guard inside the train window
and the divergence detector (counterpart of ``sheeprl_tpu/resilience/health.py``).

* **Non-finite guard.**  :meth:`HealthSentinel.wrap` returns the loop's
  train window with the guard inside it: the trained tensors (parameters,
  targets, Moments and the optimizers' state, a ``capturable`` Adam's step
  tensors included) are copied into a backup allocated once; the window
  runs; its loss (the sum of the means of its metrics) and, with
  ``health.check_params``, the new parameters reduce to one 0-d device bool;
  every trained tensor then takes its new or its backed-up value by
  ``torch.where``.  A select, never an arithmetic blend: ``0 · NaN`` is NaN
  and ``-0.0 + 0.0`` is ``+0.0``, so a window that stands is bit for bit
  the unguarded one, and a skipped window leaves the state bit for bit as
  it was.  Nothing reads the device, so the guard runs inside
  ``steady_guard`` and inside a captured CUDA graph: the wrapped function is
  what ``fabric.compile`` captures (DreamerV3) or runs eagerly (the rest of
  the family, SAC and DroQ, the CPU).  The backup is written in place, and
  the live tensors are written in place, never rebound, so a captured graph
  keeps reading the buffers it saw.  An eager Adam on the card keeps its
  step count on the host (a captured one is ``capturable``, its step on
  the card); that step is backed up on the host, the flag is copied into
  pinned host memory without waiting, and the select happens at
  :meth:`HealthSentinel.settle`: at the start of the next window, and before
  the loop saves or polls, when the flag has long landed.
* **Divergence detector.**  :class:`HealthState` is nine 0-d device tensors
  updated in place by JAX's formulas: an EMA of the finite window loss, a
  window spikes when ``loss - ema > spike_factor * (|ema| + spike_min)``
  after ``min_windows`` windows, ``patience`` consecutive spikes latch
  ``diverged``.  The host reads it only in :meth:`HealthSentinel.poll`,
  every ``health.poll_every_updates`` iterations (and at the last), outside
  the window; ``poll`` returns ``"rollback"`` when the detector fired and
  ``health.divergence.action=rollback``: SAC and DroQ then reload the
  newest committed snapshot in the loop (``checkpoint/rollback.py``), the
  Dreamer family raises :class:`DivergenceError`, as in JAX.
* **Planted faults.**  ``update.grads`` specs (``nonfinite``: the window's
  parameters and loss poisoned with NaN; ``divergence``: the loss the
  detector sees multiplied by ``health.divergence.fault_scale``) are
  resolved from the active fault plan when the sentinel is built and fire
  at their ``at``/``every`` guarded window, counted on the device, so a
  planted fault adds no host traffic.

The guard skips a whole window (a chunk of updates), as JAX's does: the
window is one program and cannot say which update went bad.  A loop's
sentinel registers with the telemetry hub (:meth:`HealthSentinel.register`,
source ``health``), which reads the ``Health/*`` values cached at the last
poll and never the device, and its skips, spikes, divergence and rollbacks
land in the flight recorder.
"""

from __future__ import annotations

import functools
import warnings
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.resilience.faults import active_plan
from sheeprl_tpu_torch.telemetry.hub import HUB
from sheeprl_tpu_torch.telemetry.recorder import RECORDER

#: ``() -> (parameters, optimizer state)``: the trained tensors a guarded window covers
StateFn = Callable[[], Tuple[Sequence[torch.Tensor], Sequence[torch.Tensor]]]


class DivergenceError(RuntimeError):
    """Training diverged and in-loop rollback is unavailable or exhausted:
    no committed snapshot to roll back to, ``health.divergence.max_rollbacks``
    spent, or a loop without in-loop rollback (the Dreamer family).  A
    relaunch with ``checkpoint.resume_from=auto`` is the rollback then."""


class HealthState(NamedTuple):
    """The detector's state: 0-d tensors on the device, updated in place."""

    dispatches: torch.Tensor  # int32: guarded windows so far
    applied: torch.Tensor  # int32: windows whose update stood
    skipped: torch.Tensor  # int32: windows the non-finite guard skipped
    nonfinite_loss: torch.Tensor  # int32: windows whose loss itself was not finite
    last_loss: torch.Tensor  # float32: newest finite window loss
    ema: torch.Tensor  # float32: EMA of the finite window loss
    spike_run: torch.Tensor  # int32: consecutive spiking windows
    spike_total: torch.Tensor  # int32: spiking windows in all
    diverged: torch.Tensor  # int32: sticky divergence flag


def _zero_state(device: Any) -> HealthState:
    return HealthState(*(torch.zeros((), dtype=torch.float32 if f in ("last_loss", "ema") else torch.int32,
                                     device=device) for f in HealthState._fields))


def loss_scalar(metrics: Iterable[torch.Tensor]) -> torch.Tensor:
    """One fp32 scalar of a window's metrics: the sum, in order, of the
    means of its floating tensors (JAX's ``loss_scalar``)."""
    total = None
    for m in metrics:
        if m.is_floating_point():
            mean = m.mean().float()
            total = mean if total is None else total + mean
    return total if total is not None else torch.zeros(())


def tensors_finite(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """One 0-d bool: every element of every floating tensor is finite."""
    flags = [torch.isfinite(t).all() for t in tensors if t.is_floating_point()]
    return torch.stack(flags).all() if flags else torch.ones((), dtype=torch.bool)


def _spec_fire_count(spec: Any, lo: int, hi: int) -> int:
    """How many guarded windows in ``(lo, hi]`` ``spec`` fires at (host
    arithmetic mirroring the device's schedule)."""
    fires = 0
    if spec.at is not None and lo < int(spec.at) <= hi:
        fires += 1
    if spec.every is not None and int(spec.every) > 0:
        e = int(spec.every)
        top = hi // e
        if spec.max_fires is not None:
            top = min(top, int(spec.max_fires))
        fires += max(0, top - lo // e)
    return fires


def _f32(x: float) -> float:
    return float(np.float32(x))


class HealthSentinel:
    """The guard and detector of one train loop.

    1. ``HealthSentinel.from_config(cfg)``: None with ``health.enabled=False``
       (the window stays exactly the unguarded one);
    2. ``fabric.compile(sentinel.wrap(window, state_fn, device), ...)``: the
       guarded window, which returns what ``window`` returns (a tuple whose
       last item is the window's metrics);
    3. per iteration, ``sentinel.should_poll(update, total_iters)`` and then
       ``sentinel.poll(policy_step)``: the only read of the device, which
       returns ``"rollback"`` when the detector fired and rollback is set.
    """

    HUB_SOURCE = "health"

    def __init__(self, hcfg: Any):
        hcfg = hcfg or {}
        self.check_params = bool(hcfg.get("check_params", True))
        self.poll_every = max(1, int(hcfg.get("poll_every_updates", 25) or 1))
        self.ema_decay = float(hcfg.get("ema_decay", 0.99))
        self.spike_factor = float(hcfg.get("spike_factor", 10.0))
        self.spike_min = float(hcfg.get("spike_min", 1.0))
        self.min_windows = int(hcfg.get("min_windows", 20))
        self.patience = max(1, int(hcfg.get("patience", 3) or 1))
        dcfg = hcfg.get("divergence") or {}
        self.action = str(dcfg.get("action", "none"))
        if self.action not in ("none", "rollback"):
            raise ValueError(f"health.divergence.action must be none|rollback, got {self.action!r}")
        self.max_rollbacks = int(dcfg.get("max_rollbacks", 3))
        self.divergence_scale = float(dcfg.get("fault_scale", 1e6))
        self.rollbacks = 0
        # planted update.grads faults, resolved once: cli.run installs the
        # plan before the loops build their windows
        plan = active_plan()
        self._trace_specs: List[Any] = plan.specs_for("update.grads") if plan is not None else []
        self.state: Optional[HealthState] = None
        self._backup: List[torch.Tensor] = []
        self._backup_key: List[Tuple[Any, ...]] = []
        # the host-resident trained tensors of the last window and their
        # backups, selected once its flag (copied to pinned memory) has landed
        self._pending: Optional[Tuple[List[torch.Tensor], List[torch.Tensor]]] = None
        self._ok_host: Optional[torch.Tensor] = None
        self._ok_event: Any = None
        self._metrics: Dict[str, float] = {}
        self._prev = {"dispatches": 0, "skipped": 0, "nonfinite_loss": 0, "spike_total": 0}
        self._diverged_reported = False
        self._registered = False

    @classmethod
    def from_config(cls, cfg: Any) -> Optional["HealthSentinel"]:
        hcfg = cfg.get("health") or {}
        return cls(hcfg) if hcfg.get("enabled", True) else None

    # -- the guard ----------------------------------------------------------------
    def _fire(self, d: torch.Tensor, kind: str) -> Optional[torch.Tensor]:
        """OR of the planted ``update.grads`` schedules of ``kind`` at guarded
        window ``d`` (a 0-d device tensor); None when nothing of ``kind`` is
        planted, so nothing is added to the window."""
        preds = []
        for spec in self._trace_specs:
            if spec.kind != kind:
                continue
            if spec.at is not None:
                preds.append(d == int(spec.at))
            if spec.every is not None and int(spec.every) > 0:
                e = int(spec.every)
                cond = (d % e) == 0
                if spec.max_fires is not None:
                    cond = cond & ((d // e) <= int(spec.max_fires))
                preds.append(cond)
        return functools.reduce(torch.logical_or, preds) if preds else None

    def _backup_for(self, live: List[torch.Tensor]) -> List[torch.Tensor]:
        """The backup buffers of ``live``, allocated once; again only when the
        set of trained tensors changed (an eager loop that rebound them)."""
        key = [(t.data_ptr(), t.shape, t.dtype, t.device) for t in live]
        if key != self._backup_key:
            if live and live[0].is_cuda and torch.cuda.is_current_stream_capturing():
                raise RuntimeError("health guard: the trained tensors changed between a window's first call and "
                                   "its capture; a captured window must update its state in place")
            self._backup = [torch.empty_like(t) for t in live]
            self._backup_key = key
        return self._backup

    def wrap(self, window: Callable, state_fn: StateFn, device: Any) -> Callable:
        """``window`` with the guard inside (module docstring).  ``state_fn()``
        gives the trained tensors: the parameters (checked and, for a planted
        ``nonfinite``, poisoned) and the optimizer state, which must exist
        before the first window (``ClippedOptimizer.init_state_``).  The
        :class:`HealthState` is allocated here, on ``device``."""
        self.state = _zero_state(device)
        h = self.state
        check_params = self.check_params
        decay = _f32(self.ema_decay)
        one_minus_decay = float(np.float32(1.0) - np.float32(self.ema_decay))
        factor, smin = _f32(self.spike_factor), _f32(self.spike_min)
        min_windows, patience = self.min_windows, self.patience
        div_scale = _f32(self.divergence_scale)

        @functools.wraps(window)
        def guarded(*args: Any, **kwargs: Any):
            self.settle()
            params, opt_state = state_fn()
            params = [t for t in params if t.is_floating_point()]
            live = [*params, *opt_state]
            backup = self._backup_for(live)
            on_dev = [i for i, t in enumerate(live) if t.device == h.ema.device]
            host = [i for i, t in enumerate(live) if t.device != h.ema.device]
            if host and torch.cuda.is_current_stream_capturing():
                raise RuntimeError("health guard: a captured window's trained tensors must all be on the card "
                                   "(build its Adam capturable)")
            with torch.no_grad():
                if on_dev:
                    torch._foreach_copy_([backup[i] for i in on_dev], [live[i] for i in on_dev])
                for i in host:
                    backup[i].copy_(live[i])
            out = window(*args, **kwargs)
            with torch.no_grad():
                d = h.dispatches + 1
                loss = loss_scalar(out[-1]).to(h.ema.device)
                nan_fire, div_fire = self._fire(d, "nonfinite"), self._fire(d, "divergence")
                if nan_fire is not None:
                    for t in params:
                        torch.where(nan_fire, torch.full((), float("nan"), dtype=t.dtype, device=t.device), t,
                                    out=t)
                    loss = torch.where(nan_fire, torch.full_like(loss, float("nan")), loss)
                if div_fire is not None:
                    loss = loss * torch.where(div_fire, torch.full_like(loss, div_scale), torch.ones_like(loss))

                # the non-finite guard: every trained tensor, new or backed up
                loss_ok = torch.isfinite(loss)
                ok = loss_ok & tensors_finite(params) if check_params else loss_ok
                for i in on_dev:
                    torch.where(ok, live[i], backup[i], out=live[i])
                if host:
                    self._defer([live[i] for i in host], [backup[i] for i in host], ok)

                # the spike / divergence detector over the finite loss stream
                loss_f = torch.where(loss_ok, loss, h.last_loss)
                seeded = (h.applied + h.skipped) > 0
                ema_prev = torch.where(seeded, h.ema, loss_f)
                spike = loss_ok & (d >= min_windows) & ((loss_f - ema_prev) > factor * (ema_prev.abs() + smin))
                # a spike is kept out of the EMA: repeated spikes stay spikes
                ema_new = torch.where(spike, ema_prev, decay * ema_prev + one_minus_decay * loss_f)
                spike_run = torch.where(spike, h.spike_run + 1, torch.zeros_like(h.spike_run))
                oki, loss_oki = ok.to(torch.int32), loss_ok.to(torch.int32)
                new = HealthState(
                    dispatches=d, applied=h.applied + oki, skipped=h.skipped + (1 - oki),
                    nonfinite_loss=h.nonfinite_loss + (1 - loss_oki), last_loss=loss_f, ema=ema_new,
                    spike_run=spike_run, spike_total=h.spike_total + spike.to(torch.int32),
                    diverged=torch.maximum(h.diverged, (spike_run >= patience).to(torch.int32)),
                )
                torch._foreach_copy_(list(h), list(new))
            return out

        return guarded

    def _defer(self, live: List[torch.Tensor], backup: List[torch.Tensor], ok: torch.Tensor) -> None:
        """Copy ``ok`` into pinned host memory without waiting; :meth:`settle`
        selects ``live`` or ``backup`` once it has landed."""
        if self._ok_host is None:
            self._ok_host = torch.zeros((), dtype=torch.bool).pin_memory()
            self._ok_event = torch.cuda.Event()
        self._ok_host.copy_(ok, non_blocking=True)
        self._ok_event.record()
        self._pending = (live, backup)

    def settle(self) -> None:
        """Finish the last window's select of its host-resident tensors (an
        eager Adam's step counts on the card): a read of pinned host memory
        that the device wrote long ago; it waits only when called before the
        window's work is done."""
        if self._pending is None:
            return
        live, backup = self._pending
        self._pending = None
        if not self._ok_event.query():
            self._ok_event.synchronize()
        if not bool(self._ok_host):
            with torch.no_grad():
                for t, b in zip(live, backup):
                    t.copy_(b)

    # -- the host side ------------------------------------------------------------
    def register(self) -> "HealthSentinel":
        """Publish :meth:`metrics` through the telemetry hub."""
        HUB.register(self.HUB_SOURCE, self.metrics)
        self._registered = True
        return self

    def close(self) -> None:
        if self._registered:
            HUB.unregister(self.HUB_SOURCE)
            self._registered = False

    def metrics(self) -> Dict[str, float]:
        """The newest polled ``Health/*`` values (empty before the first poll)."""
        return dict(self._metrics)

    def should_poll(self, update: int, total_iters: int) -> bool:
        return update % self.poll_every == 0 or update >= total_iters

    def poll(self, policy_step: int) -> str:
        """Read the state (one copy from the device, outside the window),
        update the metrics, and return ``"rollback"`` when the detector fired
        and ``health.divergence.action=rollback``, else ``"none"``."""
        self.settle()
        vals = dict(zip(HealthState._fields, torch.stack([t.double() for t in self.state]).tolist()))
        d, skipped, spike_total = int(vals["dispatches"]), int(vals["skipped"]), int(vals["spike_total"])
        nonfinite = int(vals["nonfinite_loss"])
        diverged = bool(vals["diverged"])
        lo = self._prev["dispatches"]
        if d > lo and self._trace_specs:
            from sheeprl_tpu_torch.telemetry.monitors import RESILIENCE_MONITOR

            for spec in self._trace_specs:
                for _ in range(_spec_fire_count(spec, lo, d)):
                    RESILIENCE_MONITOR.record_injection("update.grads", spec.kind)
        new_skips = skipped - self._prev["skipped"]
        if new_skips > 0:
            RECORDER.record("health.skip", count=new_skips, nonfinite_loss=nonfinite - self._prev["nonfinite_loss"],
                            step=int(policy_step))
        new_spikes = spike_total - self._prev["spike_total"]
        if new_spikes > 0:
            RECORDER.record("health.spike", count=new_spikes, loss=vals["last_loss"], ema=vals["ema"],
                            step=int(policy_step))
        if diverged and not self._diverged_reported:
            self._diverged_reported = True
            RECORDER.record("health.diverged", step=int(policy_step), ema=vals["ema"])
            if self.action != "rollback":
                warnings.warn(
                    f"training-health sentinel: loss diverged at step {policy_step} (health.divergence.action=none "
                    "— continuing; set health.divergence.action=rollback to restore the last committed checkpoint)",
                    RuntimeWarning,
                )
        self._prev = {"dispatches": d, "skipped": skipped, "nonfinite_loss": nonfinite, "spike_total": spike_total}
        self._metrics = {
            "Health/windows": float(d),
            "Health/applied": vals["applied"],
            "Health/skipped": float(skipped),
            "Health/nonfinite_loss": vals["nonfinite_loss"],
            "Health/loss_last": vals["last_loss"],
            "Health/loss_ema": vals["ema"],
            "Health/spike_windows": float(spike_total),
            "Health/diverged": float(diverged),
            "Health/rollbacks": float(self.rollbacks),
        }
        return "rollback" if diverged and self.action == "rollback" else "none"

    def reseed_state(self) -> None:
        """After a rollback: the counters and the sticky flag cleared in place,
        the guarded-window count kept (planted schedules and the
        ``min_windows`` warm-up key on it, and a rollback must not replay
        them)."""
        with torch.no_grad():
            for name, t in zip(HealthState._fields, self.state):
                if name != "dispatches":
                    t.zero_()
        self._prev.update(skipped=0, nonfinite_loss=0, spike_total=0)
        self._diverged_reported = False

    def begin_rollback(self, policy_step: int) -> None:
        """Count one rollback; raise :class:`DivergenceError` past
        ``health.divergence.max_rollbacks``."""
        self.rollbacks += 1
        if self.rollbacks > self.max_rollbacks:
            raise DivergenceError(
                f"training diverged at step {policy_step} and the in-loop rollback budget "
                f"(health.divergence.max_rollbacks={self.max_rollbacks}) is exhausted"
            )

    def rolled_back(self, policy_step: int, resume_step: Any) -> None:
        RECORDER.record("health.rollback", step=int(policy_step), resume_step=str(resume_step))
        self._metrics["Health/rollbacks"] = float(self.rollbacks)
