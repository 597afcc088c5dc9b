"""Plan2Explore over DreamerV1, the finetuning phase (counterpart of
``sheeprl_tpu/algos/p2e_dv1/p2e_dv1_finetuning.py``): the exploration
snapshot's world model and task critic, and the actor
``algo.player.actor_type`` chooses, then DreamerV1 training."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import DV1Trainer
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import dreamer_family_loop
from sheeprl_tpu_torch.algos.p2e_utils import exploration_initial_state, project_exploration_state
from sheeprl_tpu_torch.utils.registry import register_algorithm


def exploration_state_to_dv1(state: Dict[str, Any], actor_type: str = "task") -> Dict[str, Any]:
    """Project an exploration snapshot onto the DreamerV1 state layout."""
    return project_exploration_state(state, actor_type, keep_keys=("world_model", "critic"))


@register_algorithm(name="p2e_dv1_finetuning")
def main(fabric: Any, cfg: Any) -> None:
    initial_state = exploration_initial_state(cfg, exploration_state_to_dv1)
    dreamer_family_loop(fabric, cfg, build_agent, DV1Trainer, initial_state=initial_state)
