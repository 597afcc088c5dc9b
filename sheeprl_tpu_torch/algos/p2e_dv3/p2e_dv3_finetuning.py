"""Plan2Explore over DreamerV3, the finetuning phase (counterpart of
``sheeprl_tpu/algos/p2e_dv3/p2e_dv3_finetuning.py``).

Loads the exploration snapshot named by ``checkpoint.exploration_ckpt_path``
(a committed ``step_*`` directory or a run directory), keeps its world
model, task critic and target critic and Moments, takes the task actor (or
the exploration actor, by ``algo.player.actor_type``), and the replay
buffer with ``buffer.load_from_exploration``; then trains DreamerV3 on the
task reward from there.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer, dreamer_family_loop
from sheeprl_tpu_torch.algos.p2e_utils import exploration_initial_state, project_exploration_state
from sheeprl_tpu_torch.utils.registry import register_algorithm


def exploration_state_to_dv3(state: Dict[str, Any], actor_type: str = "task") -> Dict[str, Any]:
    """Project an exploration snapshot onto the DreamerV3 state layout."""
    return project_exploration_state(
        state, actor_type,
        keep_keys=("world_model", "critic", "target_critic"),
        defaults={"moments": {"low": torch.zeros(()), "high": torch.zeros(())}},
    )


@register_algorithm(name="p2e_dv3_finetuning")
def main(fabric: Any, cfg: Any) -> None:
    initial_state = exploration_initial_state(cfg, exploration_state_to_dv3)
    dreamer_family_loop(fabric, cfg, build_agent, DV3Trainer, initial_state=initial_state)
