"""Run loggers and versioned log directories (counterpart of
``sheeprl_tpu/utils/logger.py``, one process).

``<log_dir>/<root_dir>/<run_name>/version_k`` is created per run.  Backends:
CSV (always available) and TensorBoard, which needs ``tensorboardX`` and
says so when it is absent.
"""

from __future__ import annotations

import csv
import os
from typing import Any, Dict, Optional


class CSVLogger:
    """Rows of ``step,name,value`` in ``<log_dir>/metrics.csv``."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._path = os.path.join(log_dir, "metrics.csv")
        if not os.path.exists(self._path):
            with open(self._path, "w", newline="") as f:
                csv.writer(f).writerow(["step", "name", "value"])

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        with open(self._path, "a", newline="") as f:
            w = csv.writer(f)
            for k, v in metrics.items():
                w.writerow([step, k, v])

    def close(self) -> None:
        pass


class TensorBoardLogger:
    def __init__(self, log_dir: str):
        try:
            from tensorboardX import SummaryWriter
        except ImportError as e:
            raise ImportError(
                "metric.logger=tensorboard needs the tensorboardX package, which is not installed; "
                "pass metric/logger=csv for the CSV logger"
            ) from e
        self.log_dir = log_dir
        self.writer = SummaryWriter(log_dir)

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        for k, v in metrics.items():
            self.writer.add_scalar(k, v, step)

    def close(self) -> None:
        self.writer.close()


def get_log_dir(root_dir: str, run_name: str, base: str = "logs/runs") -> str:
    """Create the next free ``version_k`` directory of the run."""
    root = os.path.join(base, root_dir, run_name)
    version = 0
    while os.path.isdir(os.path.join(root, f"version_{version}")):
        version += 1
    log_dir = os.path.join(root, f"version_{version}")
    os.makedirs(log_dir, exist_ok=True)
    return log_dir


def get_logger(cfg: Any, log_dir: str) -> Optional[Any]:
    """The configured logger, or None at ``metric.log_level`` 0.

    Also the central telemetry arm-point: every train loop and evaluation
    builds its logger here, so ``telemetry.setup_run`` (spans, trace
    windows, the flight recorder's run directory, the introspection
    endpoint) needs no per-loop wiring.  The logger is attached to the hub,
    so the ``finally`` path of ``cli.run`` lands the last metric window
    after a crash."""
    from sheeprl_tpu_torch import telemetry

    telemetry.setup_run(cfg, log_dir, rank=0)
    if cfg.metric.get("log_level", 1) <= 0:
        return None
    kind = cfg.metric.logger.kind if "logger" in cfg.metric else "tensorboard"
    if kind == "tensorboard":
        logger = TensorBoardLogger(log_dir)
    elif kind == "csv":
        logger = CSVLogger(log_dir)
    else:
        raise NotImplementedError(f"metric.logger={kind}: the port has the csv and tensorboard loggers")
    telemetry.HUB.attach_logger(logger)
    return logger
