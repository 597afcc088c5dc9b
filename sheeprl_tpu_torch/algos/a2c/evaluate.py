"""A2C evaluation (counterpart of ``sheeprl_tpu/algos/a2c/evaluate.py``): the
agent is PPO's, and so is its test episode."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.ppo.evaluate import evaluate as evaluate_ppo
from sheeprl_tpu_torch.utils.registry import register_evaluation


@register_evaluation(algorithms="a2c")
def evaluate(fabric: Any, cfg: Any, state: Dict[str, Any]) -> float:
    return evaluate_ppo(fabric, cfg, state)
