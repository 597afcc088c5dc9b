"""Optional-dependency availability flags (counterpart of ``sheeprl_tpu/utils/imports.py``)."""

from __future__ import annotations

import importlib.util


def _available(mod: str) -> bool:
    try:
        return importlib.util.find_spec(mod) is not None
    except Exception:
        return False


_IS_ALE_AVAILABLE = _available("ale_py")
_IS_DMC_AVAILABLE = _available("dm_control")
_IS_CRAFTER_AVAILABLE = _available("crafter")
_IS_MINERL_AVAILABLE = _available("minerl")
_IS_MINEDOJO_AVAILABLE = _available("minedojo")
_IS_DIAMBRA_AVAILABLE = _available("diambra")
_IS_SMB_AVAILABLE = _available("gym_super_mario_bros")
_IS_MLFLOW_AVAILABLE = _available("mlflow")
