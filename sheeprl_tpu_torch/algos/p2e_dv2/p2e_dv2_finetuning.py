"""Plan2Explore over DreamerV2, the finetuning phase (counterpart of
``sheeprl_tpu/algos/p2e_dv2/p2e_dv2_finetuning.py``): the exploration
snapshot's world model, task critic and target, and the actor
``algo.player.actor_type`` chooses, then DreamerV2 training."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import DV2Trainer, build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import dreamer_family_loop
from sheeprl_tpu_torch.algos.p2e_utils import exploration_initial_state, project_exploration_state
from sheeprl_tpu_torch.utils.registry import register_algorithm


def exploration_state_to_dv2(state: Dict[str, Any], actor_type: str = "task") -> Dict[str, Any]:
    """Project an exploration snapshot onto the DreamerV2 state layout."""
    return project_exploration_state(state, actor_type, keep_keys=("world_model", "critic", "target_critic"))


@register_algorithm(name="p2e_dv2_finetuning")
def main(fabric: Any, cfg: Any) -> None:
    initial_state = exploration_initial_state(cfg, exploration_state_to_dv2)
    dreamer_family_loop(fabric, cfg, build_agent, DV2Trainer, initial_state=initial_state)
