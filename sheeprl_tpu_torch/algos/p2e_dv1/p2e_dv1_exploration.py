"""Plan2Explore over DreamerV1, the exploration phase (counterpart of
``sheeprl_tpu/algos/p2e_dv1/p2e_dv1_exploration.py``).

An ensemble of ``n`` forward models (no LayerNorm) predicts the next
stochastic state from (latent ⊕ action); its prediction variance is the
intrinsic reward.  Two policies train in every update
(:class:`~sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1.DV1Trainer` with the
ensembles): the exploration actor (``actor``, the one the player acts with)
and ``critic_exploration`` on the intrinsic return, the task actor
(``actor_task``) and the task critic on the extrinsic one.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent as dv1_build_agent
from sheeprl_tpu_torch.algos.dreamer_v1.agent import new_actor, new_critic
from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import DV1Trainer
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import dreamer_family_loop, evaluate_dreamer
from sheeprl_tpu_torch.algos.p2e_utils import add_exploration_modules, p2e_optimizers
from sheeprl_tpu_torch.utils.registry import register_algorithm, register_evaluation


def build_agent(fabric: Any, actions_dim: Sequence[int], is_continuous: bool, cfg: Any, obs_space: Any,
                state: Optional[Dict[str, Any]] = None) -> Dict[str, torch.nn.Module]:
    """The DreamerV1 agent (its actor explores), the ensembles, the task
    actor and the exploration critic (DreamerV1 keeps no target critic)."""
    modules = dv1_build_agent(fabric, actions_dim, is_continuous, cfg, obs_space, state)
    return add_exploration_modules(fabric, cfg, modules, actions_dim, is_continuous, state, new_actor, new_critic,
                                   target_critic=False)


@register_algorithm(name="p2e_dv1_exploration")
def main(fabric: Any, cfg: Any) -> None:
    dreamer_family_loop(fabric, cfg, build_agent, DV1Trainer, optimizer_builder=p2e_optimizers)


@register_evaluation(algorithms=["p2e_dv1_exploration", "p2e_dv1_finetuning"])
def evaluate(fabric: Any, cfg: Any, state: Dict[str, Any]) -> float:
    return evaluate_dreamer(fabric, cfg, state, dv1_build_agent)
