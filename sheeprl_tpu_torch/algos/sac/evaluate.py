"""SAC evaluation (counterpart of ``sheeprl_tpu/algos/sac/evaluate.py``)."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.sac.agent import build_agent
from sheeprl_tpu_torch.algos.sac.sac import evaluate_agent
from sheeprl_tpu_torch.utils.registry import register_evaluation


@register_evaluation(algorithms=["sac", "sac_decoupled"])
def evaluate(fabric: Any, cfg: Any, state: Dict[str, Any]) -> float:
    """One greedy test episode of a SAC (or decoupled SAC) snapshot; returns the cumulative reward."""
    return evaluate_agent(fabric, cfg, state, build_agent)
