"""Model registry on the filesystem (counterpart of
``sheeprl_tpu/utils/model_manager.py``).

A versioned store of named models with metadata, laid out as the JAX
package lays it out::

    <registry_root>/<model_name>/v<k>/{params.pt, meta.yaml}

``meta.yaml`` holds ``name``, ``version``, ``description``, ``stage``,
``registered_at`` and ``metadata`` (``algo``, ``env``, ``seed``).  The port
writes a model's parameters in its own idiom: the sub-model's tensors on the
CPU with ``torch.save`` (``params.pt``, read back with
``weights_only=True``).  A version the JAX package registered holds a
pickled numpy tree (``params.pkl``); it loads as that tree, through the
restricted unpickler of ``checkpoint/serialize.py``.
"""

from __future__ import annotations

import csv
import io
import shutil
import time
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch
import yaml

#: the port's parameters file, and the JAX package's
PARAMS_FILE, JAX_PARAMS_FILE = "params.pt", "params.pkl"


class AbstractModelManager(ABC):
    """The registry's lifecycle: register, latest version, load, stage
    transition, delete."""

    @abstractmethod
    def register_model(self, name: str, params: Any, description: str = "", metadata: Optional[Dict] = None) -> int: ...

    @abstractmethod
    def get_latest_version(self, name: str) -> Optional[int]: ...

    @abstractmethod
    def load_model(self, name: str, version: Optional[int] = None) -> Any: ...

    @abstractmethod
    def transition_model(self, name: str, version: int, stage: str) -> None: ...

    @abstractmethod
    def delete_model(self, name: str, version: Optional[int] = None) -> None: ...


def params_bytes(params: Any) -> bytes:
    """``params`` on the CPU (numpy arrays as tensors), ``torch.save``d."""
    from sheeprl_tpu_torch.checkpoint.manager import to_host

    buf = io.BytesIO()
    torch.save(to_host(params), buf)
    return buf.getvalue()


def read_params(path: Path) -> Any:
    """A registered model's parameters: the port's ``params.pt`` or a
    JAX-written ``params.pkl``."""
    if path.name == JAX_PARAMS_FILE:
        from sheeprl_tpu_torch.checkpoint.serialize import load_jax_pickle

        return load_jax_pickle(path)
    return torch.load(path, map_location="cpu", weights_only=True)


class FileSystemModelManager(AbstractModelManager):
    def __init__(self, registry_root: str = "models_registry"):
        self.root = Path(registry_root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _model_dir(self, name: str) -> Path:
        return self.root / name

    def _versions(self, name: str) -> List[int]:
        d = self._model_dir(name)
        if not d.is_dir():
            return []
        return sorted(int(p.name[1:]) for p in d.iterdir() if p.name.startswith("v"))

    def register_model(self, name: str, params: Any, description: str = "", metadata: Optional[Dict] = None) -> int:
        from sheeprl_tpu_torch.checkpoint.serialize import durable_write

        version = (self.get_latest_version(name) or 0) + 1
        vdir = self._model_dir(name) / f"v{version}"
        vdir.mkdir(parents=True, exist_ok=True)
        durable_write(vdir / PARAMS_FILE, params_bytes(params))
        with open(vdir / "meta.yaml", "w") as f:
            yaml.safe_dump(
                {
                    "name": name,
                    "version": version,
                    "description": description,
                    "stage": "None",
                    "registered_at": time.strftime("%Y-%m-%d %H:%M:%S"),
                    "metadata": metadata or {},
                },
                f,
            )
        return version

    def get_latest_version(self, name: str) -> Optional[int]:
        versions = self._versions(name)
        return versions[-1] if versions else None

    def get_model_info(self, name: str, version: Optional[int] = None) -> Dict[str, Any]:
        version = version or self.get_latest_version(name)
        with open(self._model_dir(name) / f"v{version}" / "meta.yaml") as f:
            return yaml.safe_load(f)

    def load_model(self, name: str, version: Optional[int] = None) -> Any:
        version = version or self.get_latest_version(name)
        if version is None:
            raise FileNotFoundError(f"No registered versions of model '{name}'")
        return read_params(Path(self.download_model(name, version)))

    def transition_model(self, name: str, version: int, stage: str) -> None:
        meta_path = self._model_dir(name) / f"v{version}" / "meta.yaml"
        with open(meta_path) as f:
            meta = yaml.safe_load(f)
        meta["stage"] = stage
        with open(meta_path, "w") as f:
            yaml.safe_dump(meta, f)

    def delete_model(self, name: str, version: Optional[int] = None) -> None:
        if version is None:
            shutil.rmtree(self._model_dir(name), ignore_errors=True)
        else:
            shutil.rmtree(self._model_dir(name) / f"v{version}", ignore_errors=True)

    def download_model(self, name: str, version: Optional[int] = None) -> str:
        """The path of a version's parameters file (``params.pt``, or the
        JAX package's ``params.pkl``)."""
        vdir = self._model_dir(name) / f"v{version or self.get_latest_version(name)}"
        port_file, jax_file = vdir / PARAMS_FILE, vdir / JAX_PARAMS_FILE
        return str(jax_file if jax_file.exists() and not port_file.exists() else port_file)

    def models(self) -> List[str]:
        return sorted(p.name for p in self.root.iterdir() if p.is_dir())


def _run_best_metric(run_dir: Path, metric: str) -> Optional[float]:
    """Best (max) value of ``metric`` a run logged, from its metrics.csv (the
    CSV logger) or its TensorBoard event files when their reader is
    installed."""
    best: Optional[float] = None
    csv_path = run_dir / "metrics.csv"
    if csv_path.exists():
        with open(csv_path) as f:
            for row in csv.DictReader(f):
                if row.get("name") == metric:
                    v = float(row["value"])
                    best = v if best is None else max(best, v)
        return best
    try:
        from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    except ImportError:
        return None
    for events in run_dir.glob("events.out.tfevents.*"):
        acc = EventAccumulator(str(events))
        acc.Reload()
        if metric in acc.Tags().get("scalars", ()):
            vals = [s.value for s in acc.Scalars(metric)]
            if vals:
                m = max(vals)
                best = m if best is None else max(best, m)
    return best


def last_checkpoint(version_dir: Path) -> Optional[Path]:
    """A run's newest committed snapshot, else its newest legacy ``ckpt_*.ckpt``."""
    from sheeprl_tpu_torch.checkpoint.protocol import latest_checkpoint

    newest = latest_checkpoint(version_dir / "checkpoint")
    if newest is not None:
        return newest
    ckpts = sorted((version_dir / "checkpoint").glob("ckpt_*.ckpt"))
    return ckpts[-1] if ckpts else None


def register_best_models(
    log_dir: str,
    cfg: Any,
    metric: str = "Rewards/rew_avg",
    models_keys: Optional[set] = None,
) -> Dict[str, int]:
    """Scan every run under ``log_dir`` (``**/version_*``), pick the one whose
    logged ``metric`` peaked highest, and register the sub-models of that
    run's last checkpoint (a JAX-written one converted for ``cfg``)."""
    from sheeprl_tpu_torch.serve.loader import load_state

    best_run, best_val = None, None
    for vdir in sorted(Path(log_dir).glob("**/version_*")):
        ckpt = last_checkpoint(vdir)
        if ckpt is None:
            continue
        val = _run_best_metric(vdir, metric)
        if val is None:
            continue
        if best_val is None or val > best_val:
            best_run, best_val = ckpt, val
    if best_run is None:
        return {}
    return register_model_from_checkpoint(None, cfg, load_state(best_run, cfg, "cpu"), models_keys=models_keys)


def register_model_from_checkpoint(
    fabric: Any, cfg: Any, state: Dict[str, Any], models_keys: Optional[set] = None
) -> Dict[str, int]:
    """Register a checkpoint's sub-models with the backend
    ``model_manager.backend`` selects (``mlflow_manager.get_model_manager``),
    under the names and descriptions of ``model_manager.models``."""
    from sheeprl_tpu_torch.utils.mlflow_manager import get_model_manager

    manager = get_model_manager(cfg)
    agent_state = state.get("agent", {})
    models_cfg = cfg.get("model_manager", {}).get("models", {}) or {}
    versions = {}
    keys = models_keys or set(models_cfg) or set(agent_state if isinstance(agent_state, dict) else [])
    for key in keys:
        sub = agent_state.get(key) if isinstance(agent_state, dict) else None
        if sub is None and key == "agent":
            sub = agent_state
        if sub is None:
            continue
        info = models_cfg.get(key, {}) if isinstance(models_cfg.get(key), dict) else {}
        name = info.get("model_name", f"{cfg.algo.name}_{key}")
        versions[key] = manager.register_model(
            name, sub, description=info.get("description", f"{cfg.algo.name} {key}"),
            metadata={"algo": cfg.algo.name, "env": cfg.env.id, "seed": cfg.seed},
        )
    return versions
