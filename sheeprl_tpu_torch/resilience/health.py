"""Training-health sentinels: the non-finite guard and the report-only
divergence detector (counterpart of ``sheeprl_tpu/resilience/health.py``).

* **Non-finite guard.**  Before a train window the loop hands the sentinel
  a copy of its state (parameters, optimizer state, moments); after it,
  :meth:`HealthSentinel.check` reduces the window's loss (the sum of the
  means of its metrics) and, with ``health.check_params``, the updated
  parameters to one finiteness flag.  A window that fails is undone: the
  loop restores the copy, so a NaN never reaches the weights.  One device
  synchronisation per window reads the flag; the loops make that read
  after a window's ``steady_guard`` block (``buffer.transfer_guard``), never
  inside it, since the guard refuses a read that waits on the device.
* **Divergence detector.**  An EMA of the finite window loss; a window
  spikes when ``loss - ema > spike_factor * (|ema| + spike_min)`` after
  ``min_windows`` windows, and ``patience`` consecutive spikes latch the
  diverged flag, which is reported (a warning and ``Health/diverged``).
  ``health.divergence.action=rollback`` is not ported yet and raises.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Iterable, Optional

import torch


def loss_scalar(metrics: Iterable[torch.Tensor]) -> torch.Tensor:
    """The sum of the means of a window's metric tensors."""
    return torch.stack([m.float().mean() for m in metrics]).sum()


def tensors_finite(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """One 0-d bool: every element of every floating tensor is finite."""
    flags = [torch.isfinite(t).all() for t in tensors if t.is_floating_point()]
    return torch.stack(flags).all() if flags else torch.tensor(True)


class HealthSentinel:
    def __init__(self, hcfg: Any):
        hcfg = hcfg or {}
        self.check_params = bool(hcfg.get("check_params", True))
        self.ema_decay = float(hcfg.get("ema_decay", 0.99))
        self.spike_factor = float(hcfg.get("spike_factor", 10.0))
        self.spike_min = float(hcfg.get("spike_min", 1.0))
        self.min_windows = int(hcfg.get("min_windows", 20))
        self.patience = max(1, int(hcfg.get("patience", 3) or 1))
        action = str((hcfg.get("divergence") or {}).get("action", "none"))
        if action == "rollback":
            raise NotImplementedError(
                "health.divergence.action=rollback is not ported yet (ROADMAP.md, queue A item 6); "
                "the port's sentinel reports divergence (action=none)"
            )
        if action != "none":
            raise ValueError(f"health.divergence.action must be none|rollback, got {action!r}")
        self.windows = self.applied = self.skipped = self.nonfinite_loss = 0
        self.spike_run = self.spike_total = 0
        self.last_loss = self.ema = 0.0
        self.diverged = False

    @classmethod
    def from_config(cls, cfg: Any) -> Optional["HealthSentinel"]:
        hcfg = cfg.get("health") or {}
        return cls(hcfg) if hcfg.get("enabled", True) else None

    def check(self, metrics: Iterable[torch.Tensor], params: Iterable[torch.Tensor], step: int = 0) -> bool:
        """Whether the window that produced ``metrics`` and ``params`` may
        stand; updates the counters and the divergence detector."""
        loss = loss_scalar(metrics)
        loss_ok_t = torch.isfinite(loss)
        ok_t = loss_ok_t & tensors_finite(params) if self.check_params else loss_ok_t
        loss_ok, ok, loss = bool(loss_ok_t), bool(ok_t), float(loss)
        self.windows += 1
        self.applied += ok
        self.skipped += not ok
        self.nonfinite_loss += not loss_ok
        if loss_ok:
            seeded = self.windows > 1
            ema = self.ema if seeded else loss
            spike = self.windows >= self.min_windows and loss - ema > self.spike_factor * (abs(ema) + self.spike_min)
            self.ema = ema if spike else self.ema_decay * ema + (1.0 - self.ema_decay) * loss
            self.spike_run = self.spike_run + 1 if spike else 0
            self.spike_total += spike
            self.last_loss = loss
            if self.spike_run >= self.patience and not self.diverged:
                self.diverged = True
                warnings.warn(
                    f"training-health sentinel: loss diverged at step {step} "
                    "(health.divergence.action=none — continuing)",
                    RuntimeWarning,
                )
        return ok

    def metrics(self) -> Dict[str, float]:
        return {
            "Health/windows": float(self.windows),
            "Health/applied": float(self.applied),
            "Health/skipped": float(self.skipped),
            "Health/nonfinite_loss": float(self.nonfinite_loss),
            "Health/loss_last": float(self.last_loss),
            "Health/loss_ema": float(self.ema),
            "Health/spike_windows": float(self.spike_total),
            "Health/diverged": float(self.diverged),
        }
