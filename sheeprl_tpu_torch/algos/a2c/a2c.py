"""A2C on one device (counterpart of ``sheeprl_tpu/algos/a2c/a2c.py``, its
host path).

The loop is PPO's :func:`~sheeprl_tpu_torch.algos.ppo.ppo.on_policy_loop`
with the agent, player and rollout of PPO; the update is one full-batch
gradient step per rollout: GAE from the values of the current weights, then
``policy_loss + vf_coef · value_loss - ent_coef · mean entropy``, the two
losses under ``algo.loss_reduction`` (``sum`` by default) and the entropy
always a mean.  Only the learning rate is annealed.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple, Union

import torch

from sheeprl_tpu_torch.algos.a2c.loss import policy_loss, value_loss
from sheeprl_tpu_torch.algos.ppo.agent import evaluate_actions
from sheeprl_tpu_torch.algos.ppo.ppo import OnPolicyTrainer, Rollout, on_policy_loop
from sheeprl_tpu_torch.utils.registry import register_algorithm


class A2CTrainer(OnPolicyTrainer):
    """The A2C update of one rollout."""

    SCHEDULES = ("lr",)
    STORES_LOGPROBS = False  # the update evaluates the actions under the current weights

    def train_phase(self, rollout: Rollout, last_obs: Dict[str, torch.Tensor],
                    perms: Union[torch.Generator, Sequence[torch.Tensor], None], clip_coef: float,
                    ent_coef: float) -> Tuple[torch.Tensor, ...]:
        """One gradient step on the whole rollout (``perms`` and
        ``clip_coef`` are unused).  Returns (policy loss, value loss, mean
        entropy): the logged entropy is the positive mean, not a loss."""
        loss, losses = self.loss(self.flat_rollout(rollout, last_obs), clip_coef, ent_coef)
        self.step(loss)
        return tuple(x.detach() for x in losses)

    def loss(self, flat: Rollout, clip_coef: Any, ent_coef: Any, agent: Any = None):
        """``policy_loss + vf_coef · value_loss - ent_coef · mean entropy`` of
        the whole rollout and its three parts (``clip_coef`` is unused);
        ``agent`` replaces ``self.agent``, as in PPO's."""
        out, new_values = (agent or self.agent)({k: flat[k] for k in self.obs_keys})
        lp, ent = evaluate_actions(out, flat["actions"], self.actions_dim, self.is_continuous, self.dist_type)
        pg = policy_loss(lp, flat["advantages"], self.reduction)
        vl = value_loss(new_values[..., 0], flat["returns"], self.reduction)
        e = ent.mean()
        return pg + self.vf_coef * vl - ent_coef * e, (pg, vl, e)


@register_algorithm()
def main(fabric: Any, cfg: Any) -> None:
    on_policy_loop(fabric, cfg, A2CTrainer)
