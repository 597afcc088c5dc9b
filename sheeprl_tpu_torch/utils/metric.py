"""Metric aggregation (counterpart of ``sheeprl_tpu/utils/metric.py``).

A dict of named running metrics that train loops ``update``; ``compute``
drops NaNs and non-scalars.  Values may be 0-d tensors on the card:
``update`` stores them as given and ``compute`` reads them, so the loop
synchronises with the device once per log interval, not per update.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from sheeprl_tpu_torch.telemetry.hub import HUB


def _to_float(v: Any) -> Optional[float]:
    if hasattr(v, "detach"):  # a torch tensor
        if v.numel() != 1:
            return None
        return float(v.detach().reshape(()).item())
    arr = np.asarray(v, dtype=np.float64)
    return float(arr.reshape(())) if arr.size == 1 else None


class _RunningMetric:
    """One named accumulator: mode 'mean' | 'sum' | 'last' | 'max' | 'min'."""

    def __init__(self, mode: str = "mean"):
        if mode not in ("mean", "sum", "last", "max", "min"):
            raise ValueError(f"Unknown metric mode: {mode}")
        self.mode = mode
        self.reset()

    def reset(self) -> None:
        self._values: List[Any] = []

    def update(self, value: Any) -> None:
        self._values.append(value)

    @property
    def empty(self) -> bool:
        return not self._values

    def compute(self) -> Optional[float]:
        vals = [_to_float(v) for v in self._values]
        if not vals or any(v is None for v in vals):
            return None
        arr = np.asarray(vals)
        arr = arr[~np.isnan(arr)]
        if arr.size == 0:
            return None
        return float({"mean": np.mean, "sum": np.sum, "last": lambda a: a[-1], "max": np.max, "min": np.min}[
            self.mode
        ](arr))


class MetricAggregator:
    def __init__(self, metrics: Optional[Dict[str, str]] = None, raise_on_missing: bool = False):
        self.metrics: Dict[str, _RunningMetric] = {}
        self.raise_on_missing = raise_on_missing
        for name, mode in (metrics or {}).items():
            self.add(name, mode)

    def add(self, name: str, mode: str = "mean") -> None:
        if name not in self.metrics:
            self.metrics[name] = _RunningMetric(mode if isinstance(mode, str) else "mean")

    def update(self, name: str, value: Any) -> None:
        if name not in self.metrics:
            if self.raise_on_missing:
                raise KeyError(f"Unregistered metric: {name}")
            return
        self.metrics[name].update(value)

    def reset(self) -> None:
        for m in self.metrics.values():
            m.reset()

    def compute(self) -> Dict[str, float]:
        """Finite scalar values only (NaNs and non-scalars dropped)."""
        out: Dict[str, float] = {}
        for name, metric in self.metrics.items():
            if metric.empty:
                continue
            val = metric.compute()
            if val is not None and np.isfinite(val):
                out[name] = val
        return out


def flush_metrics(
    aggregator: MetricAggregator,
    timer_obj: Any,
    logger: Any,
    policy_step: int,
    last_log: int,
    extra_metrics: Optional[Dict[str, float]] = None,
) -> int:
    """The end-of-interval flush every train loop shares: compute and reset
    the aggregator, drain the named timers, derive the two steps-per-second
    rates, merge ``extra_metrics`` and the telemetry hub's sources
    (``Compile/*``, ``Checkpoint/*``, ``Resilience/*``, ``Phase/*``, a
    loop's ``Health/*``), log, and return the new ``last_log``.  The hub's
    flush rolls the span window: the metric interval is the phase window."""
    metrics = aggregator.compute()
    aggregator.reset()
    times = timer_obj.to_dict(reset=True)
    steps_since = max(policy_step - last_log, 1)
    if "Time/env_interaction_time" in times:
        metrics["Time/sps_env_interaction"] = steps_since / max(times["Time/env_interaction_time"], 1e-9)
    if "Time/train_time" in times:
        metrics["Time/sps_train"] = steps_since / max(times["Time/train_time"], 1e-9)
    if extra_metrics:
        metrics.update(extra_metrics)
    metrics.update(times)
    metrics.update(HUB.flush(roll=True))
    HUB.note_step(policy_step)
    if logger is not None and metrics:
        logger.log_metrics(metrics, policy_step)
    return policy_step
