"""DroQ on one device (counterpart of ``sheeprl_tpu/algos/droq/droq.py``):
SAC's loop and update with the dropout critic, whose dropout runs in all
three critic calls of an update (the target, the critic loss and the
actor's Q), with masks drawn from the train generator on the device."""

from __future__ import annotations

from typing import Any

from sheeprl_tpu_torch.algos.droq.agent import build_agent
from sheeprl_tpu_torch.algos.sac.sac import SACTrainer, off_policy_loop
from sheeprl_tpu_torch.utils.registry import register_algorithm


@register_algorithm()
def main(fabric: Any, cfg: Any) -> None:
    off_policy_loop(fabric, cfg, build_agent, SACTrainer)
