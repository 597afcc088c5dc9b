"""SAC-AE evaluation (counterpart of ``sheeprl_tpu/algos/sac_ae/evaluate.py``)."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.sac.sac import evaluate_agent
from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent
from sheeprl_tpu_torch.algos.sac_ae.sac_ae import PixelLayout, SACAETrainer
from sheeprl_tpu_torch.utils.registry import register_evaluation


@register_evaluation(algorithms="sac_ae")
def evaluate(fabric: Any, cfg: Any, state: Dict[str, Any]) -> float:
    """One greedy test episode of a SAC-AE snapshot; returns the cumulative reward."""
    return evaluate_agent(fabric, cfg, state, build_agent, SACAETrainer, PixelLayout)
