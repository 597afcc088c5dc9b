"""Plan2Explore over DreamerV2, the exploration phase (counterpart of
``sheeprl_tpu/algos/p2e_dv2/p2e_dv2_exploration.py``).

An ensemble of ``n`` forward models (no LayerNorm) predicts the next
stochastic state from (latent ⊕ action); its prediction variance is the
intrinsic reward.  Two policies train in every update
(:class:`~sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2.DV2Trainer` with the
ensembles): the exploration actor (``actor``, the one the player acts with)
with ``critic_exploration`` and its hard-copied target on the intrinsic
return, and the task actor (``actor_task``) with the task critic on the
extrinsic one.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import DV2Trainer, new_actor, new_critic
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import build_agent as dv2_build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import dreamer_family_loop, evaluate_dreamer
from sheeprl_tpu_torch.algos.p2e_utils import add_exploration_modules, p2e_optimizers
from sheeprl_tpu_torch.utils.registry import register_algorithm, register_evaluation


def build_agent(fabric: Any, actions_dim: Sequence[int], is_continuous: bool, cfg: Any, obs_space: Any,
                state: Optional[Dict[str, Any]] = None) -> Dict[str, torch.nn.Module]:
    """The DreamerV2 agent (its actor explores), the ensembles, the task
    actor, and the exploration critic with its target."""
    modules = dv2_build_agent(fabric, actions_dim, is_continuous, cfg, obs_space, state)
    return add_exploration_modules(fabric, cfg, modules, actions_dim, is_continuous, state, new_actor, new_critic,
                                   target_critic=True)


@register_algorithm(name="p2e_dv2_exploration")
def main(fabric: Any, cfg: Any) -> None:
    dreamer_family_loop(fabric, cfg, build_agent, DV2Trainer, optimizer_builder=p2e_optimizers)


@register_evaluation(algorithms=["p2e_dv2_exploration", "p2e_dv2_finetuning"])
def evaluate(fabric: Any, cfg: Any, state: Dict[str, Any]) -> float:
    return evaluate_dreamer(fabric, cfg, state, dv2_build_agent)
