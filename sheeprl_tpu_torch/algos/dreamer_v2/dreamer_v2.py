"""DreamerV2 training (counterpart of ``sheeprl_tpu/algos/dreamer_v2/dreamer_v2.py``).

The DreamerV3 module family configured for V2: ``algo.dense_act``
activations, ``algo.layer_norm`` stages, no unimix, no symlog inputs,
unit-variance Gaussian observation, reward and value heads (``bins=1``),
no learnable initial state and no kernel flag (the JAX ``build_agent`` passes none,
so DreamerV2 launches no kernel).  One update (:meth:`DV2Trainer.train_step`):

* the world model: the posterior scan, the Gaussian reconstruction NLLs and
  the α-balanced KL (``kl_balancing_alpha``);
* the behaviour: an imagination of ``horizon + 1`` steps, λ-returns on the
  target critic's values, the actor's ``objective_mix`` of REINFORCE and
  dynamics backprop, the critic's Gaussian NLL;
* a hard copy of the critic into its target every
  ``target_network_update_freq`` updates, counting from the window's
  ``counter0`` as JAX does.

With Plan2Explore (the modules of ``p2e_dv2_exploration``) the ensembles
train on the posterior latents and two behaviour updates run: the
exploration actor (``actor``) with ``critic_exploration`` and its hard-copied
target on the ensemble disagreement, then the task actor (``actor_task``)
with the task critic on the extrinsic reward.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from sheeprl_tpu_torch.algos.dreamer_v2.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v3.agent import Actor, Critic, WorldModel, obs_shapes, place_modules
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


def latent_size(cfg: Any) -> int:
    wm_cfg = cfg.algo.world_model
    return int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size) + int(wm_cfg.recurrent_model.recurrent_state_size)


def new_actor(cfg: Any, actions_dim: Sequence[int], is_continuous: bool, dtype: torch.dtype = torch.float32) -> Actor:
    a = cfg.algo.actor
    return Actor(latent_size(cfg), actions_dim, is_continuous, dense_units=a.dense_units, mlp_layers=a.mlp_layers,
                 act=cfg.algo.dense_act, layer_norm=bool(cfg.algo.layer_norm), unimix=0.0, min_std=a.min_std,
                 max_std=1.0, init_std=a.init_std, action_clip=1.0, dtype=dtype)


def new_critic(cfg: Any, dtype: torch.dtype = torch.float32) -> Critic:
    c = cfg.algo.critic
    return Critic(latent_size(cfg), dense_units=c.dense_units, mlp_layers=c.mlp_layers, act=cfg.algo.dense_act,
                  layer_norm=bool(cfg.algo.layer_norm), bins=1, dtype=dtype)


def build_agent(fabric: Any, actions_dim: Sequence[int], is_continuous: bool, cfg: Any, obs_space: Any,
                state: Optional[Dict[str, Any]] = None) -> Dict[str, torch.nn.Module]:
    """World model, actor, critic and target critic with the V2 settings, in
    eval mode on ``fabric.device``: from ``state``, or initialised from
    ``cfg.seed`` with the target a copy of the critic.  The modules compute in
    ``fabric.precision.compute_dtype``."""
    cnn_shapes, mlp_shapes = obs_shapes(cfg, obs_space)
    wm_cfg = cfg.algo.world_model
    dtype = fabric.precision.compute_dtype
    with torch.device("meta" if state is not None else fabric.device):
        modules = {
            "world_model": WorldModel(
                cnn_keys=tuple(cfg.algo.cnn_keys.encoder), mlp_keys=tuple(cfg.algo.mlp_keys.encoder),
                cnn_shapes=cnn_shapes, mlp_shapes=mlp_shapes, actions_dim=tuple(actions_dim),
                cnn_mult=wm_cfg.encoder.cnn_channels_multiplier, dense_units=cfg.algo.dense_units,
                mlp_layers=cfg.algo.mlp_layers, recurrent_size=wm_cfg.recurrent_model.recurrent_state_size,
                hidden_size=wm_cfg.transition_model.hidden_size,
                repr_hidden_size=wm_cfg.representation_model.hidden_size,
                stochastic_size=wm_cfg.stochastic_size, discrete_size=wm_cfg.discrete_size, unimix=0.0, bins=1,
                act=cfg.algo.dense_act, layer_norm=bool(cfg.algo.layer_norm), symlog_inputs=False,
                learnable_initial_state=False, dtype=dtype,
            ),
            "actor": new_actor(cfg, actions_dim, is_continuous, dtype),
            "critic": new_critic(cfg, dtype),
            "target_critic": new_critic(cfg, dtype),
        }
    place_modules(modules, state, fabric.device, int(cfg.seed), {"target_critic": "critic"})
    return modules


class DV2Trainer(DreamerTrainer):
    """The modules and optimizers of one DreamerV2 run (or the exploration
    phase of Plan2Explore over it, when ``modules`` holds ``ensembles``),
    and its update."""

    def __init__(self, cfg: Any, modules: Dict[str, torch.nn.Module], optimizers: Dict[str, ClippedOptimizer],
                 cnn_keys: Sequence[str], mlp_keys: Sequence[str], is_continuous: bool,
                 agent_state: Optional[Dict[str, Any]] = None):
        super().__init__(cfg, modules, optimizers, cnn_keys, mlp_keys, is_continuous)
        self.task_rollout = "ensembles" in modules
        self.targets = {"target_critic": "critic"}
        if self.task_rollout:
            self.targets["target_critic_exploration"] = "critic_exploration"
            self.intrinsic_mult = float(cfg.algo.intrinsic_reward_multiplier)
        for target in self.targets:
            modules[target].requires_grad_(False)
        algo = cfg.algo
        self.target_freq = int(algo.critic.target_network_update_freq)
        self.ent_coef = float(algo.actor.ent_coef)
        self.objective_mix = float(algo.actor.objective_mix)
        wm = algo.world_model
        self.kl_cfg = dict(kl_balancing_alpha=float(wm.kl_balancing_alpha), kl_free_nats=float(wm.kl_free_nats),
                           kl_regularizer=float(wm.kl_regularizer))
        self.use_continues = bool(wm.use_continues)
        self.discount_scale = float(wm.discount_scale_factor)

    def wm_forward(self, data: Dict[str, torch.Tensor], post_noise: torch.Tensor):
        wm = self.world_model
        L, B = data["rewards"].shape
        obs, embed, actions, is_first = self.encode_block(data)
        hs, zs, post_logits, prior_logits = self.posterior_scan(embed, actions, is_first, post_noise)
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
            continue_loss = -self.discount_scale * Bernoulli(wm.continue_logits(flat).reshape(L, B)).log_prob(
                (1.0 - data["terminated"]) * self.gamma)
        loss, aux = reconstruction_loss(obs_loss, reward_loss, continue_loss, post_logits, prior_logits,
                                        **self.kl_cfg)
        aux.update(latents=latents, post_logits=post_logits, prior_logits=prior_logits)
        return loss, aux

    def behavior(self, actor: Actor, critic: Critic, target_critic: Critic, latents: torch.Tensor,
                 terminated: torch.Tensor, action_noise, imag_noise, actor_opt: str, critic_opt: str,
                 intrinsic: bool = False):
        """Imagination, λ-returns on the target critic's values, the actor's
        ``objective_mix`` of REINFORCE and dynamics backprop, the critic's
        Gaussian NLL; the reward is the world model's, or the ensemble
        disagreement with ``intrinsic``."""
        wm = self.world_model
        H, n = self.horizon, terminated.numel()
        start = latents.detach().reshape(n, -1)
        with frozen(wm):
            # only the dynamics term (weight 1 - objective_mix) differentiates
            # the imagination; without it the rollout needs no graph
            with torch.enable_grad() if self.objective_mix != 1.0 else torch.no_grad():
                traj, actions_seq = self.imagine(actor, start, action_noise, imag_noise)
                flat = traj.reshape((H + 1) * n, -1)
                if intrinsic:
                    with torch.no_grad():
                        preds = self.agent["ensembles"](torch.cat([traj, actions_seq], dim=-1).reshape((H + 1) * n, -1))
                        rewards = ensemble_disagreement(preds.reshape(preds.shape[0], H + 1, n, -1),
                                                        self.intrinsic_mult)
                        self.last_intrinsic = rewards.mean()
                else:
                    rewards = wm.reward_logits(flat).reshape(H + 1, n)
                values = target_critic(flat).reshape(H + 1, n)
                if self.use_continues:
                    # the head predicts γ·(1 - done): back to (1 - done)
                    continues = Bernoulli(wm.continue_logits(flat).reshape(H + 1, n)).mean / self.gamma
                else:
                    continues = torch.ones((H + 1, n), device=self.device)
                continues = torch.cat([(1.0 - terminated).reshape(1, n), continues[1:]], dim=0)
                lambda_values = compute_lambda_values(rewards[1:], values[1:], continues[1:] * self.gamma,
                                                      self.lmbda)
                discount = (torch.cumprod(continues * self.gamma, dim=0) / self.gamma).detach()
            advantage = (lambda_values - values[:-1]).detach()
            heads = actor(traj.detach())
            reinforce = actor.log_prob(heads[:-1], actions_seq[:-1].detach()) * advantage
            objective = self.objective_mix * reinforce + (1 - self.objective_mix) * lambda_values
            entropy = actor.entropy(heads[:-1])
            policy_loss = -torch.mean(discount[:-1] * (objective + self.ent_coef * entropy))
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
            pl_e, vl_e = self.behavior(m["actor"], m["critic_exploration"], m["target_critic_exploration"], latents,
                                       terminated, noise["actions"], noise["imagination"], "actor",
                                       "critic_exploration", intrinsic=True)
            pl_t, vl_t = self.behavior(m["actor_task"], m["critic"], m["target_critic"], latents, terminated,
                                       noise["actions_task"], noise["imagination_task"], "actor_task", "critic")
            policy_loss, value_loss = pl_e + pl_t, vl_e + vl_t
        else:
            policy_loss, value_loss = self.behavior(m["actor"], m["critic"], m["target_critic"], latents, terminated,
                                                    noise["actions"], noise["imagination"], "actor", "critic")
        if counter % self.target_freq == 0:
            with torch.no_grad():
                for target, online in self.targets.items():
                    m[target].load_state_dict(m[online].state_dict())
        return self.metrics(wm_loss, aux, policy_loss, value_loss)


@register_algorithm()
def main(fabric: Any, cfg: Any) -> None:
    dreamer_family_loop(fabric, cfg, build_agent, DV2Trainer)


@register_evaluation(algorithms="dreamer_v2")
def evaluate(fabric: Any, cfg: Any, state: Dict[str, Any]) -> float:
    return evaluate_dreamer(fabric, cfg, state, build_agent)
