"""Model registry on an MLflow tracking server (counterpart of
``sheeprl_tpu/utils/mlflow_manager.py``), and the backend dispatch.

:func:`get_model_manager` chooses the backend from
``model_manager.backend``: ``filesystem`` (the default,
:class:`~sheeprl_tpu_torch.utils.model_manager.FileSystemModelManager`) or
``mlflow``.  :class:`MlflowModelManager` has the same lifecycle against an
MLflow server or ``file:`` store: a model's parameters are logged as a
``torch.save`` artifact (``params.pt``) under a run, registered as a model
version, and every register, transition and delete appends to a markdown
changelog on the registered model and on the version.  ``mlflow`` is an
optional dependency imported only when the backend is built; without it
the backend raises ``ModuleNotFoundError`` (:func:`_require_mlflow`).
"""

from __future__ import annotations

import getpass
import os
import tempfile
import time
import warnings
from pathlib import Path
from typing import Any, Dict, Optional

from sheeprl_tpu_torch.utils.imports import _IS_MLFLOW_AVAILABLE
from sheeprl_tpu_torch.utils.model_manager import PARAMS_FILE, AbstractModelManager, params_bytes, read_params

VERSION_MD_TEMPLATE = "## **Version {}**\n"
DESCRIPTION_MD_TEMPLATE = "### Description: \n{}\n"
#: the stage API this backend drives is mlflow 2.x's; from 2.9 stages are
#: deprecated (removed in 3.x) and transitions fall back to model aliases
MLFLOW_TESTED_RANGE = ">=2.0,<2.9"


def _mlflow_major_minor() -> tuple:
    import mlflow

    try:
        return tuple(int(p) for p in mlflow.__version__.split(".")[:2])
    except (ValueError, AttributeError):
        return (0, 0)


def _require_mlflow():
    if not _IS_MLFLOW_AVAILABLE:
        raise ModuleNotFoundError(
            "mlflow is not installed; use FileSystemModelManager or install mlflow "
            "(model_manager.backend=mlflow requires the optional dependency)"
        )
    import mlflow  # deferred: the module imports without the dependency

    return mlflow


class MlflowModelManager(AbstractModelManager):
    """Registry backend against an MLflow tracking server."""

    def __init__(self, tracking_uri: Optional[str] = None, experiment_name: str = "sheeprl_tpu"):
        mlflow = _require_mlflow()
        from mlflow.tracking import MlflowClient

        if _mlflow_major_minor() >= (2, 9):
            warnings.warn(
                f"mlflow {mlflow.__version__} is outside the tested range {MLFLOW_TESTED_RANGE}: stage "
                "transitions fall back to registered-model aliases (stages were deprecated in 2.9)"
            )
        self.tracking_uri = tracking_uri or os.environ.get("MLFLOW_TRACKING_URI", "file:./mlruns")
        mlflow.set_tracking_uri(self.tracking_uri)
        self.experiment_name = experiment_name
        self.client = MlflowClient()

    # -- helpers ---------------------------------------------------------
    @staticmethod
    def _get_author_and_date() -> str:
        try:
            user = getpass.getuser()
        except (KeyError, OSError):
            user = "unknown"
        return f"### Author: {user}, Date: {time.strftime('%d/%m/%Y %H:%M:%S')}\n"

    @staticmethod
    def _generate_description(description: Optional[str] = None) -> str:
        return "" if description is None else DESCRIPTION_MD_TEMPLATE.format(description)

    def _safe_get_stage(self, name: str, version: int) -> Optional[str]:
        """A version's stage; None when the version does not exist, the
        string ``"None"`` when it exists with no stage."""
        try:
            mv = self.client.get_model_version(name, str(version))
        except Exception:  # noqa: BLE001 - mlflow raises its own exception types
            warnings.warn(f"Model {name} version {version} not found")
            return None
        stage = getattr(mv, "current_stage", None)
        if stage in (None, "None"):
            # alias mode (mlflow >= 2.9): the stage lives in a version tag
            return (getattr(mv, "tags", None) or {}).get("stage") or "None"
        return stage

    def _append_changelog(self, name: str, version: Optional[str], entry: str) -> None:
        model_desc = self.client.get_registered_model(name).description or ""
        header = "# MODEL CHANGELOG\n" if not model_desc else ""
        self.client.update_registered_model(name, header + model_desc + entry)
        if version is not None:
            ver_desc = self.client.get_model_version(name, version).description or ""
            ver_header = "# MODEL CHANGELOG\n" if not ver_desc else ""
            self.client.update_model_version(name, version, ver_header + ver_desc + entry)

    def _version_entry(self, version: Any, description: str) -> str:
        return (VERSION_MD_TEMPLATE.format(version) + self._get_author_and_date()
                + self._generate_description(description or None))

    # -- lifecycle -------------------------------------------------------
    def register_model(self, name: str, params: Any, description: str = "", metadata: Optional[Dict] = None) -> int:
        """Save the parameters, log them under a run, register the artifact
        as a new model version, and append a changelog entry."""
        mlflow = _require_mlflow()
        mlflow.set_experiment(self.experiment_name)
        with mlflow.start_run(run_name=f"register-{name}") as run:
            with tempfile.TemporaryDirectory() as tmp:
                path = Path(tmp) / PARAMS_FILE
                path.write_bytes(params_bytes(params))
                mlflow.log_artifact(str(path))
            model_uri = f"runs:/{run.info.run_id}/{PARAMS_FILE}"
        model_version = mlflow.register_model(model_uri=model_uri, name=name, tags=metadata)
        self._append_changelog(name, model_version.version, self._version_entry(model_version.version, description))
        return int(model_version.version)

    def register_model_from_uri(self, model_location: str, name: str, description: str = "",
                                metadata: Optional[Dict] = None) -> int:
        """Register an artifact that already lives in the tracking store."""
        mlflow = _require_mlflow()
        model_version = mlflow.register_model(model_uri=model_location, name=name, tags=metadata)
        self._append_changelog(name, model_version.version, self._version_entry(model_version.version, description))
        return int(model_version.version)

    def get_latest_version(self, name: str) -> Optional[int]:
        try:
            versions = self.client.search_model_versions(f"name='{name}'")
        except Exception:  # noqa: BLE001 - an unknown model
            return None
        return max((int(v.version) for v in versions), default=None)

    def load_model(self, name: str, version: Optional[int] = None) -> Any:
        return read_params(Path(self.download_model(name, version)))

    def transition_model(self, name: str, version: int, stage: str, description: Optional[str] = None) -> None:
        previous_stage = self._safe_get_stage(name, version)
        if previous_stage is None:
            return
        if previous_stage.lower() == stage.lower():
            warnings.warn(f"Model {name} version {version} is already in stage {stage}")
            return
        if hasattr(self.client, "transition_model_version_stage") and _mlflow_major_minor() < (2, 9):
            new_stage = self.client.transition_model_version_stage(name=name, version=str(version),
                                                                   stage=stage).current_stage
        else:
            # the alias is the stage label; a version leaves its previous stage
            if previous_stage.lower() != "none":
                try:
                    held = self.client.get_model_version_by_alias(name, previous_stage.lower())
                    if str(held.version) == str(version):
                        self.client.delete_registered_model_alias(name, previous_stage.lower())
                except Exception:  # noqa: BLE001 - no such alias
                    pass
            self.client.set_registered_model_alias(name, stage.lower(), str(version))
            self.client.set_model_version_tag(name, str(version), "stage", stage)
            new_stage = stage
        entry = ("## **Transition:**\n" + f"### Version {version} from {previous_stage} to {new_stage}\n"
                 + self._get_author_and_date() + self._generate_description(description))
        self._append_changelog(name, str(version), entry)

    def delete_model(self, name: str, version: Optional[int] = None, description: Optional[str] = None) -> None:
        """Delete one version (the registered model's changelog keeps it) or,
        with ``version=None``, the whole registered model."""
        if version is None:
            try:
                self.client.delete_registered_model(name)
            except Exception:  # noqa: BLE001 - an unknown model
                warnings.warn(f"Model {name} not found")
            return
        stage = self._safe_get_stage(name, version)
        if stage is None:
            return
        self.client.delete_model_version(name, str(version))
        entry = ("## **Deletion:**\n" + f"### Version {version} from stage: {stage}\n"
                 + self._get_author_and_date() + self._generate_description(description))
        self._append_changelog(name, None, entry)

    def download_model(self, name: str, version: Optional[int] = None, output_path: Optional[str] = None) -> str:
        """Fetch a version's artifact; returns the local file path."""
        mlflow = _require_mlflow()
        version = version or self.get_latest_version(name)
        if version is None:
            raise FileNotFoundError(f"No registered versions of model '{name}'")
        artifact_uri = self.client.get_model_version_download_uri(name, str(version))
        output_path = output_path or os.path.join(tempfile.gettempdir(), f"sheeprl_tpu_torch_{name}_v{version}")
        os.makedirs(output_path, exist_ok=True)
        local = mlflow.artifacts.download_artifacts(artifact_uri=artifact_uri, dst_path=output_path)
        return os.path.join(local, PARAMS_FILE) if os.path.isdir(local) else local

    def register_best_models(self, experiment_name: str, models_info: Dict[str, Dict[str, Any]],
                             metric: str = "Test/cumulative_reward", mode: str = "max") -> Dict[str, int]:
        """Register the model artifacts of the experiment's run with the best
        ``metric``."""
        if mode not in ("max", "min"):
            raise ValueError(f"Mode must be either 'max' or 'min', got {mode}")
        experiment = self.client.get_experiment_by_name(experiment_name)
        if experiment is None:
            return {}
        models_path = [v["path"] for v in models_info.values()]
        best_run, best_artifacts = None, None
        for run in self.client.search_runs(experiment_ids=[experiment.experiment_id]):
            artifacts = [a.path for a in self.client.list_artifacts(run.info.run_id) if a.path in models_path]
            value = run.data.metrics.get(metric)
            if not artifacts or value is None:
                continue
            best = None if best_run is None else best_run.data.metrics[metric]
            if best is None or (value > best if mode == "max" else value < best):
                best_run, best_artifacts = run, set(artifacts)
        if best_run is None:
            return {}
        return {key: self.register_model_from_uri(f"runs:/{best_run.info.run_id}/{info['path']}", info["name"],
                                                  description=info.get("description", ""),
                                                  metadata=info.get("tags"))
                for key, info in models_info.items() if info["path"] in best_artifacts}


def get_model_manager(cfg: Any) -> AbstractModelManager:
    """The registry backend of ``model_manager.backend`` (``filesystem`` or ``mlflow``)."""
    from sheeprl_tpu_torch.utils.model_manager import FileSystemModelManager

    mm_cfg = cfg.get("model_manager", {}) or {}
    if mm_cfg.get("backend", "filesystem") == "mlflow":
        return MlflowModelManager(
            tracking_uri=mm_cfg.get("tracking_uri"),
            experiment_name=mm_cfg.get("experiment_name", cfg.get("exp_name", "sheeprl_tpu")),
        )
    return FileSystemModelManager(mm_cfg.get("registry_root", "models_registry"))
