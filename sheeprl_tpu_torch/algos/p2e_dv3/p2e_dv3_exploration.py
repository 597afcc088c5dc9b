"""Plan2Explore over DreamerV3, the exploration phase (counterpart of
``sheeprl_tpu/algos/p2e_dv3/p2e_dv3_exploration.py``).

On top of the DreamerV3 world model:

* an ensemble of ``n`` forward models predicts the next posterior state from
  (latent ⊕ action), trained with MSE on the posterior latents of the block;
* the intrinsic reward is the ensemble's prediction variance times
  ``intrinsic_reward_multiplier``;
* a dict of exploration critics (``critics_exploration``: intrinsic and
  extrinsic), each with its own target network and Moments; the
  exploration actor (``actor``, the one the player acts with) maximises the
  sum of their normalised advantages, each weighted by ``weight / Σ weight``;
* the task actor (``actor_task``) and the task critic train on the
  extrinsic reward alongside, as DreamerV3 does, so that finetuning starts
  from a task policy.

Each update imagines two rollouts of ``horizon + 1`` steps, one per actor,
from their own draws; with ``fused_pallas`` both run the RSSM kernel, as the
posterior scan does: 64 + 2 x 16 launches per update at batch 16 x
sequence 64, horizon 15.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from sheeprl_tpu_torch.algos.dreamer_v3.agent import Ensembles, new_actor, new_critic, place_modules
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent as dv3_build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import (
    DV3Trainer,
    dreamer_family_loop,
    ema_,
    evaluate_dreamer,
    frozen,
    zero_moments,
)
from sheeprl_tpu_torch.algos.dreamer_v3.utils import compute_lambda_values, moments_update
from sheeprl_tpu_torch.algos.p2e_utils import ensemble_disagreement, ensemble_loss, p2e_optimizers
from sheeprl_tpu_torch.utils.distribution import TwoHotEncodingDistribution
from sheeprl_tpu_torch.utils.optim import ClippedOptimizer
from sheeprl_tpu_torch.utils.registry import register_algorithm, register_evaluation


def build_agent(fabric: Any, actions_dim: Sequence[int], is_continuous: bool, cfg: Any, obs_space: Any,
                state: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The DreamerV3 agent (its actor explores), the task actor, the
    ensembles and the exploration critics (``critics_exploration[name]`` =
    {``critic``, ``target``}), in eval mode on ``fabric.device``; without
    ``state`` the extra modules are initialised from ``cfg.seed + 1``."""
    modules = dv3_build_agent(fabric, actions_dim, is_continuous, cfg, obs_space, state)
    stoch_flat = modules["world_model"].stoch_flat
    latent = stoch_flat + int(cfg.algo.world_model.recurrent_model.recurrent_state_size)
    ens = cfg.algo.ensembles
    dtype = fabric.precision.compute_dtype
    with torch.device("meta" if state is not None else fabric.device):
        extra = {
            "actor_task": new_actor(cfg, latent, actions_dim, is_continuous, dtype),
            # fp32 whatever the policy: the JAX ensembles' DreamerMLP keeps its default dtype
            "ensembles": Ensembles(int(ens.n), latent + int(sum(actions_dim)), int(ens.dense_units),
                                   int(ens.mlp_layers), stoch_flat, act=cfg.algo.dense_act),
            "critics_exploration": {name: {"critic": new_critic(cfg, latent, dtype),
                                           "target": new_critic(cfg, latent, dtype)}
                                    for name in cfg.algo.critics_exploration},
        }
    place_modules(extra, state, fabric.device, int(cfg.seed) + 1, {"target": "critic"})
    return {**modules, **extra}


class P2EDV3Trainer(DV3Trainer):
    """One Plan2Explore-DreamerV3 update (the JAX ``make_train_phase``):
    the world model, the ensembles, the exploration actor and critics, the
    task actor and critic, the task target EMA.  The noise of an update has
    the exploration rollout's draws (``actions``, ``imagination``) and the
    task rollout's (``actions_task``, ``imagination_task``)."""

    task_rollout = True
    graph_eager_reason = "Plan2Explore's window is not captured yet (ROADMAP.md, queue A item 3)"

    def __init__(self, cfg: Any, modules: Dict[str, Any], optimizers: Dict[str, ClippedOptimizer],
                 cnn_keys: Sequence[str], mlp_keys: Sequence[str], is_continuous: bool,
                 agent_state: Optional[Dict[str, Any]] = None):
        super().__init__(cfg, modules, optimizers, cnn_keys, mlp_keys, is_continuous, agent_state)
        self.actor_task = modules["actor_task"]
        self.ensembles = modules["ensembles"]
        self.critics_expl = modules["critics_exploration"]
        saved = (agent_state or {}).get("critics_exploration") or {}
        self.moments_expl = {}
        for name, pair in self.critics_expl.items():
            pair["target"].requires_grad_(False)
            self.moments_expl[name] = zero_moments((saved.get(name) or {}).get("moments"), self.device)
        self.critics_cfg = {name: (float(c["weight"]), str(c["reward_type"]))
                            for name, c in cfg.algo.critics_exploration.items()}
        self.intrinsic_mult = float(cfg.algo.intrinsic_reward_multiplier)

    def state_tree(self) -> Dict[str, Any]:
        return {**super().state_tree(), "critics_exploration": {
            name: {**pair, "moments": self.moments_expl[name]} for name, pair in self.critics_expl.items()}}

    def exploration_update(self, latents: torch.Tensor, terminated: torch.Tensor, action_noise, imag_noise):
        """The exploration actor's rollout, the intrinsic reward, each
        exploration critic's λ-returns and Moments, the actor step, then each
        critic's regression and target EMA."""
        wm = self.world_model
        H, n = self.horizon, terminated.numel()
        start = latents.detach().reshape(n, -1)
        weights_sum = sum(weight for weight, _ in self.critics_cfg.values())
        with frozen(wm, *(pair["critic"] for pair in self.critics_expl.values())):
            with torch.enable_grad() if self.is_continuous else torch.no_grad():
                traj, actions_seq = self.imagine(self.actor, start, action_noise, imag_noise)
                flat = traj.reshape((H + 1) * n, -1)
                continues = self.imagined_continues(flat, terminated)
                discount = (torch.cumprod(continues * self.gamma, dim=0) / self.gamma).detach()
                with torch.no_grad():
                    preds = self.ensembles(torch.cat([traj, actions_seq], dim=-1).reshape((H + 1) * n, -1))
                    intrinsic = ensemble_disagreement(preds.reshape(self.ensembles.n, H + 1, n, -1),
                                                      self.intrinsic_mult)
                advantage, per_critic = 0.0, {}
                for name, pair in self.critics_expl.items():
                    weight, reward_type = self.critics_cfg[name]
                    values = self.critic_mean(pair["critic"], flat)
                    if reward_type == "intrinsic":
                        reward = intrinsic
                    else:
                        reward = TwoHotEncodingDistribution(wm.reward_logits(flat).reshape(H + 1, n, -1),
                                                            dims=1).mean[..., 0]
                    lam = compute_lambda_values(reward[1:], values[1:], continues[1:] * self.gamma, self.lmbda)
                    new_moments, offset, invscale = moments_update(self.moments_expl[name], lam, **self.moments_cfg)
                    adv = (lam - offset) / invscale - (values[:-1] - offset) / invscale
                    advantage = advantage + adv * weight / weights_sum
                    per_critic[name] = (lam, new_moments)
            policy_loss = self.actor_objective(self.actor, traj, actions_seq, advantage, discount)
            self.step_optimizer("actor", policy_loss)
        value_loss = 0.0
        for name, pair in self.critics_expl.items():
            lam, new_moments = per_critic[name]
            value_loss = value_loss + self.critic_regression(pair["critic"], pair["target"], traj, lam, discount,
                                                             f"critics_exploration.{name}")
            ema_(pair["target"], pair["critic"], self.tau)
            self.moments_expl[name].update(new_moments)
        self.last_intrinsic = intrinsic.mean()
        return policy_loss.detach(), value_loss

    def train_step(self, data: Dict[str, torch.Tensor], noise: Dict[str, Any], counter: int):
        wm_loss, aux = self.world_model_update(data, noise["posterior"])
        latents = aux["latents"]
        self.step_optimizer("ensembles", ensemble_loss(self.ensembles, latents, data["actions"],
                                                       self.world_model.stoch_flat))
        pl_e, vl_e = self.exploration_update(latents, data["terminated"], noise["actions"], noise["imagination"])
        pl_t, vl_t = self.behavior(self.actor_task, self.critic, self.target_critic, self.moments, latents,
                                   data["terminated"], noise["actions_task"], noise["imagination_task"],
                                   actor_opt="actor_task")
        self.target_update(counter)
        return self.metrics(wm_loss, aux, pl_e + pl_t, vl_e + vl_t)


@register_algorithm(name="p2e_dv3_exploration")
def main(fabric: Any, cfg: Any) -> None:
    dreamer_family_loop(fabric, cfg, build_agent, P2EDV3Trainer, optimizer_builder=p2e_optimizers)


@register_evaluation(algorithms=["p2e_dv3_exploration", "p2e_dv3_finetuning"])
def evaluate(fabric: Any, cfg: Any, state: Dict[str, Any]) -> float:
    return evaluate_dreamer(fabric, cfg, state, dv3_build_agent)
