"""DreamerV1 training (counterpart of ``sheeprl_tpu/algos/dreamer_v1/dreamer_v1.py``).

One update (:meth:`DV1Trainer.train_step`): the Gaussian RSSM world model
with unit-variance reconstruction and reward NLLs plus the plain KL to the
prior above the free nats; then the behaviour: an imagination of
``horizon + 1`` steps through which the actor's gradient flows (dynamics
backprop: the actor sees the latents with their graph and maximises the
λ-returns, with no REINFORCE term, target network or return
normalisation), and the value network's Gaussian NLL of the λ-returns.
The imagination always keeps its graph.  It launches no kernel (the JAX
world model takes no kernel flag).

With Plan2Explore (the modules of ``p2e_dv1_exploration``) the ensembles
train on the posterior latents, the exploration actor (``actor``) learns
the ensemble disagreement with ``critic_exploration``, and the task actor
(``actor_task``) the extrinsic return with the task critic.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v1.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v3.agent import Actor, Critic
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import (
    DreamerTrainer,
    dreamer_family_loop,
    evaluate_dreamer,
    frozen,
)
from sheeprl_tpu_torch.algos.dreamer_v3.utils import compute_lambda_values
from sheeprl_tpu_torch.algos.p2e_utils import ensemble_disagreement, ensemble_loss
from sheeprl_tpu_torch.utils.distribution import Bernoulli, Normal
from sheeprl_tpu_torch.utils.optim import ClippedOptimizer
from sheeprl_tpu_torch.utils.registry import register_algorithm, register_evaluation


class DV1Trainer(DreamerTrainer):
    """The modules and optimizers of one DreamerV1 run (or the exploration
    phase of Plan2Explore over it, when ``modules`` holds ``ensembles``),
    and its update."""

    def __init__(self, cfg: Any, modules: Dict[str, torch.nn.Module], optimizers: Dict[str, ClippedOptimizer],
                 cnn_keys: Sequence[str], mlp_keys: Sequence[str], is_continuous: bool,
                 agent_state: Optional[Dict[str, Any]] = None):
        super().__init__(cfg, modules, optimizers, cnn_keys, mlp_keys, is_continuous)
        self.task_rollout = "ensembles" in modules
        if self.task_rollout:
            self.intrinsic_mult = float(cfg.algo.intrinsic_reward_multiplier)
        wm = cfg.algo.world_model
        self.kl_cfg = dict(kl_free_nats=float(wm.kl_free_nats), kl_regularizer=float(wm.kl_regularizer))
        self.use_continues = bool(wm.use_continues)
        self.continue_scale = float(wm.continue_scale_factor)

    def wm_forward(self, data: Dict[str, torch.Tensor], post_noise: torch.Tensor):
        wm = self.world_model
        L, B = data["rewards"].shape
        obs, embed, actions, is_first = self.encode_block(data)
        hs, zs, post, prior = self.posterior_scan(embed, actions, is_first, post_noise)
        latents = torch.cat([zs, hs], dim=-1)
        flat = latents.reshape(L * B, -1)
        recon = wm.decode(flat)
        obs_loss = 0.0
        for k in self.cnn_keys:
            obs_loss = obs_loss - Normal(recon[k].reshape(obs[k].shape), 1.0, event_dims=3).log_prob(obs[k])
        for k in self.mlp_keys:
            obs_loss = obs_loss - Normal(recon[k].reshape(L, B, -1), 1.0, event_dims=1).log_prob(obs[k])
        reward_loss = -Normal(wm.reward_logits(flat).reshape(L, B), 1.0).log_prob(data["rewards"])
        continue_loss = None
        if self.use_continues:
            continue_loss = -self.continue_scale * Bernoulli(wm.continue_logits(flat).reshape(L, B)).log_prob(
                (1.0 - data["terminated"]) * self.gamma)
        post_mean, post_std = torch.chunk(post, 2, dim=-1)
        prior_mean, prior_std = torch.chunk(prior, 2, dim=-1)
        loss, aux = reconstruction_loss(obs_loss, reward_loss, continue_loss, post_mean, post_std, prior_mean,
                                        prior_std, **self.kl_cfg)
        aux["latents"] = latents
        return loss, aux

    def behavior(self, actor: Actor, critic: Critic, latents: torch.Tensor, terminated: torch.Tensor,
                 action_noise, imag_noise, actor_opt: str, critic_opt: str, intrinsic: bool = False):
        """Imagination with the actor's graph, the λ-returns maximised by
        dynamics backprop, the value network's Gaussian NLL; the reward is
        the world model's, or the ensemble disagreement with ``intrinsic``."""
        wm = self.world_model
        H, n = self.horizon, terminated.numel()
        start = latents.detach().reshape(n, -1)
        with frozen(wm, critic):
            traj, actions_seq = self.imagine(actor, start, action_noise, imag_noise, detach_actor_input=False)
            flat = traj.reshape((H + 1) * n, -1)
            if intrinsic:
                with torch.no_grad():
                    preds = self.agent["ensembles"](torch.cat([traj, actions_seq], dim=-1).reshape((H + 1) * n, -1))
                    rewards = ensemble_disagreement(preds.reshape(preds.shape[0], H + 1, n, -1), self.intrinsic_mult)
                    self.last_intrinsic = rewards.mean()
            else:
                rewards = wm.reward_logits(flat).reshape(H + 1, n)
            values = critic(flat).reshape(H + 1, n)
            if self.use_continues:
                # the head predicts γ·(1 - done): back to (1 - done)
                continues = Bernoulli(wm.continue_logits(flat).reshape(H + 1, n)).mean / self.gamma
                continues = torch.cat([(1.0 - terminated).reshape(1, n), continues[1:]], dim=0)
            else:
                continues = torch.ones((H + 1, n), device=self.device)
            lambda_values = compute_lambda_values(rewards[1:], values[1:], continues[1:] * self.gamma, self.lmbda)
            discount = (torch.cumprod(continues * self.gamma, dim=0) / self.gamma).detach()
            policy_loss = -torch.mean(discount[:-1] * lambda_values)
            self.step_optimizer(actor_opt, policy_loss)
        flat_sg = traj[:-1].detach().reshape(H * n, -1)
        qv = Normal(critic(flat_sg).reshape(H, -1), 1.0)
        value_loss = -torch.mean(qv.log_prob(lambda_values.detach()) * discount[:-1])
        self.step_optimizer(critic_opt, value_loss)
        return policy_loss.detach(), value_loss.detach()

    def train_step(self, data: Dict[str, torch.Tensor], noise: Dict[str, Any], counter: int):
        wm_loss, aux = self.wm_forward(data, noise["posterior"])
        self.last_wm_grad_norm = self.step_optimizer("world_model", wm_loss)
        latents, terminated = aux["latents"], data["terminated"]
        m = self.agent
        if self.task_rollout:
            self.step_optimizer("ensembles", ensemble_loss(m["ensembles"], latents, data["actions"],
                                                           self.world_model.stoch_flat))
            pl_e, vl_e = self.behavior(m["actor"], m["critic_exploration"], latents, terminated, noise["actions"],
                                       noise["imagination"], "actor", "critic_exploration", intrinsic=True)
            pl_t, vl_t = self.behavior(m["actor_task"], m["critic"], latents, terminated, noise["actions_task"],
                                       noise["imagination_task"], "actor_task", "critic")
            policy_loss, value_loss = pl_e + pl_t, vl_e + vl_t
        else:
            policy_loss, value_loss = self.behavior(m["actor"], m["critic"], latents, terminated, noise["actions"],
                                                    noise["imagination"], "actor", "critic")
        return self.metrics(wm_loss, aux, policy_loss, value_loss)


@register_algorithm()
def main(fabric: Any, cfg: Any) -> None:
    dreamer_family_loop(fabric, cfg, build_agent, DV1Trainer)


@register_evaluation(algorithms="dreamer_v1")
def evaluate(fabric: Any, cfg: Any, state: Dict[str, Any]) -> float:
    return evaluate_dreamer(fabric, cfg, state, build_agent)
