"""Recurrent PPO on one device (counterpart of
``sheeprl_tpu/algos/ppo_recurrent/ppo_recurrent.py``, its host path).

The player carries the LSTM state across env steps and iterations; a done
env's next step starts with ``is_first`` (the carry zeroed inside the step)
and a zero previous action.  The update (:class:`RecurrentPPOTrainer`) runs
the whole ``(T, B)`` rollout through the agent from the carry the rollout
started with, GAE, then epochs of minibatches over env columns: ``env_bs =
min(B, per_rank_batch_size // T)`` columns each, the column permutation
padded by wrap-around, every minibatch a forward over its columns' whole
sequences.  On a device env the rollout is the Anakin one
(:func:`~sheeprl_tpu_torch.envs.device.anakin.make_recurrent_rollout_fn`):
the LSTM state, the previous actions and the episode-start mask stay on the
device in the actor carry, and the schedules come from its update counter.
With ``buffer.transfer_guard`` every update after the run's first (on the
Anakin path, the rollout with it) runs under ``steady_guard``; the host
rollout is staged before it (``stage_rollout``, ``stage_scalar``).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Sequence, Tuple, Union

import numpy as np
import torch

from sheeprl_tpu_torch.algos.ppo.agent import evaluate_actions, sample_actions
from sheeprl_tpu_torch.algos.ppo.loss import entropy_loss, policy_loss, value_loss
from sheeprl_tpu_torch.algos.ppo.ppo import check_supported, pad_permutation
from sheeprl_tpu_torch.algos.ppo.utils import actions_for_env, normalize_obs_keys, spaces_to_dims
from sheeprl_tpu_torch.algos.ppo_recurrent.agent import Carry, build_agent, one_hot_actions
from sheeprl_tpu_torch.algos.ppo_recurrent.utils import flat_obs, test
from sheeprl_tpu_torch.checkpoint.protocol import load_step_dir
from sheeprl_tpu_torch.data.buffers import ReplayBuffer
from sheeprl_tpu_torch.data.device_replay import stage_rollout, stage_scalar, steady_guard
from sheeprl_tpu_torch.envs.device import anakin_enabled, vector_env_from_cfg
from sheeprl_tpu_torch.envs.device.anakin import (
    compile_rollout,
    episode_stats_from_device,
    init_actor_state,
    make_recurrent_rollout_fn,
)
from sheeprl_tpu_torch.utils.env import episode_stats, final_obs_rows, make_env, vectorize
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, flush_metrics
from sheeprl_tpu_torch.utils.optim import ClippedOptimizer, build_optimizer, set_learning_rate
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.timer import timer
from sheeprl_tpu_torch.utils.utils import gae, normalize_tensor, polynomial_decay, save_configs


def _dist_stats(actor_out, actions, actions_dim, is_continuous):
    """Log-prob and entropy of ``actions``: a Gaussian with the log-std
    clipped to [-10, 2], or one categorical per branch (no
    ``distribution.type`` here)."""
    return evaluate_actions(actor_out, actions, actions_dim, is_continuous, "auto")


def _sample(actor_out, actions_dim, is_continuous, noise, greedy: bool = False):
    """``(actions, log_prob)`` of the distribution of :func:`_dist_stats`."""
    return sample_actions(actor_out, actions_dim, is_continuous, noise, greedy=greedy, dist_type="auto")[:2]


class RecurrentPPOTrainer:
    """The recurrent PPO update of one rollout.

    ``rollout`` holds ``(T, B, ...)`` tensors on the agent's device: each
    observation key (flat), ``actions``, ``prev_actions``, ``is_first``
    ``(T, B, 1)``, and ``logprobs``, ``rewards``, ``dones`` ``(T, B)``."""

    def __init__(self, cfg: Any, agent: torch.nn.Module, optimizer: ClippedOptimizer, actions_dim: Sequence[int],
                 is_continuous: bool, T: int, B: int):
        a = cfg.algo
        self.agent, self.optimizer = agent, optimizer
        self.actions_dim, self.is_continuous = tuple(actions_dim), is_continuous
        self.gamma, self.gae_lambda, self.vf_coef = float(a.gamma), float(a.gae_lambda), float(a.vf_coef)
        self.clip_coef, self.clip_vloss = float(a.clip_coef), bool(a.clip_vloss)
        self.normalize_adv, self.reduction = bool(a.normalize_advantages), a.loss_reduction
        self.update_epochs = int(a.update_epochs)
        self.B = B
        self.env_bs = max(1, min(B, int(a.per_rank_batch_size) // T))
        self.num_minibatches = -(-B // self.env_bs)

    def forward(self, rollout: Dict[str, torch.Tensor], init_carry: Carry, cols: torch.Tensor):
        """The agent over the whole sequences of env columns ``cols``."""
        obs = {k: rollout[k][:, cols] for k in self.agent.mlp_keys}
        return self.agent(obs, rollout["prev_actions"][:, cols], rollout["is_first"][:, cols],
                          (init_carry[0][cols], init_carry[1][cols]))

    def train_phase(self, rollout: Dict[str, torch.Tensor], init_carry: Carry, last_values: torch.Tensor,
                    perms: Union[torch.Generator, Sequence[torch.Tensor]], ent_coef: float) -> Tuple[torch.Tensor, ...]:
        """``perms``: the train generator (one column permutation per epoch)
        or the epochs' padded column orders.  Returns the last step's
        (policy, value, entropy) losses."""
        B = self.B
        with torch.no_grad():
            _, values = self.forward(rollout, init_carry, torch.arange(B, device=last_values.device))
        values = values[..., 0]
        returns, advantages = gae(rollout["rewards"], values, rollout["dones"], last_values, self.gamma,
                                  self.gae_lambda)
        losses = None
        for epoch in range(self.update_epochs):
            if isinstance(perms, torch.Generator):
                perm = pad_permutation(torch.randperm(B, generator=perms, device=perms.device),
                                       self.num_minibatches * self.env_bs)
            else:
                perm = perms[epoch]
            for i in range(self.num_minibatches):
                cols = perm[i * self.env_bs:(i + 1) * self.env_bs]
                a_out, new_values = self.forward(rollout, init_carry, cols)
                lp, ent = _dist_stats(a_out, rollout["actions"][:, cols], self.actions_dim, self.is_continuous)
                adv = advantages[:, cols]
                if self.normalize_adv:
                    adv = normalize_tensor(adv)
                pg = policy_loss(lp, rollout["logprobs"][:, cols], adv, self.clip_coef, self.reduction)
                vl = value_loss(new_values[..., 0], values[:, cols], returns[:, cols], self.clip_coef,
                                self.clip_vloss, self.reduction)
                el = entropy_loss(ent, self.reduction)
                self.optimizer.zero_grad()
                (pg + self.vf_coef * vl + ent_coef * el).backward()
                self.optimizer.step()
                losses = (pg, vl, el)
        return tuple(x.detach() for x in losses)


@register_algorithm()
def main(fabric: Any, cfg: Any) -> None:
    check_supported(cfg)
    use_anakin = anakin_enabled(cfg)
    player_device = fabric.device if use_anakin else fabric.player_device(cfg)
    train_gen, player_gen = fabric.seed_everything(int(cfg.seed), player_device)
    generators = {"train": train_gen, "player": player_gen}

    log_dir = get_log_dir(cfg.root_dir, cfg.run_name, base=cfg.get("log_dir", "logs/runs"))
    logger = get_logger(cfg, log_dir)
    ckpt_mgr = fabric.get_checkpoint_manager(cfg, log_dir)
    save_configs(cfg, log_dir)

    num_envs = int(cfg.env.num_envs)
    if use_anakin:
        envs, venv = None, vector_env_from_cfg(cfg, fabric.device)
        generators["env"] = venv.generator
        obs_space, act_space = venv.single_observation_space, venv.single_action_space
        where = f"an Anakin rollout of {num_envs} env(s) on {fabric.device}"
    else:
        envs = vectorize(cfg, [make_env(cfg, cfg.seed + i, 0, run_name=log_dir, vector_env_idx=i)
                               for i in range(num_envs)])
        obs_space, act_space = envs.single_observation_space, envs.single_action_space
        where = f"player on {player_device}, {num_envs} env(s) stepped synchronously"
    normalize_obs_keys(cfg, obs_space)
    actions_dim, is_continuous = spaces_to_dims(act_space)
    mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
    act_width = int(sum(actions_dim))
    print(f"{cfg.algo.name} on {fabric.device}: {where}", flush=True)

    state: Dict[str, Any] = {}
    if cfg.checkpoint.get("resume_from"):
        state = load_step_dir(cfg.checkpoint.resume_from, map_location="cpu")
    for name, gen in generators.items():
        if name in state.get("generators", {}):
            gen.set_state(state["generators"][name].cpu())
    agent = build_agent(fabric, actions_dim, is_continuous, cfg, obs_space, state.get("agent"))
    optimizer = build_optimizer(agent.parameters(), cfg.algo.optimizer, cfg.algo.max_grad_norm)
    if state.get("opt_state") is not None:
        optimizer.load_state_dict(state["opt_state"])
    rollout_steps = int(cfg.algo.rollout_steps)
    trainer = RecurrentPPOTrainer(cfg, agent, optimizer, actions_dim, is_continuous, rollout_steps, num_envs)
    player = agent if player_device == fabric.device else copy.deepcopy(agent).to(player_device)

    aggregator = MetricAggregator(cfg.metric.aggregator.metrics if cfg.metric.log_level > 0 else {})
    timer.configure(cfg.metric)

    policy_steps_per_iter = num_envs * rollout_steps
    total_iters = 1 if cfg.dry_run else max(int(cfg.algo.total_steps) // policy_steps_per_iter, 1)
    start_iter = int(state.get("update", 0)) + 1 if state else 1
    policy_step = int(state.get("policy_step", 0))
    last_log = int(state.get("last_log", 0))
    last_checkpoint = int(state.get("last_checkpoint", 0))
    gamma = float(cfg.algo.gamma)
    base_lr = float(cfg.algo.optimizer.lr)
    initial_ent_coef = ent_coef = float(cfg.algo.ent_coef)

    def apply_schedules(step: int) -> None:
        """The annealed learning rate and entropy coefficient at ``step`` updates."""
        nonlocal ent_coef
        if cfg.algo.anneal_lr:
            set_learning_rate(optimizer, polynomial_decay(step, initial=base_lr, final=0.0,
                                                          max_decay_steps=total_iters))
        if cfg.algo.anneal_ent_coef:
            ent_coef = polynomial_decay(step, initial=initial_ent_coef, final=0.0, max_decay_steps=total_iters)

    carry = player.initial_state(num_envs, player_device)
    prev_actions = torch.zeros(num_envs, act_width, device=player_device)
    is_first = torch.ones(num_envs, 1, device=player_device)
    max_recompiles = cfg.algo.get("max_recompiles")
    # every route through the compile-once audit; all run eagerly so far
    train_phase = fabric.compile(trainer.train_phase, name=f"{cfg.algo.name}.train_phase",
                                 max_recompiles=max_recompiles,
                                 eager_reason="the annealed learning rate and entropy coefficient are Python values")
    player_step = fabric.compile(player.step, name=f"{cfg.algo.name}.player_step",
                                 device=player_device, max_recompiles=max_recompiles,
                                 eager_reason="the host loop copies every step's actions to the env")
    if use_anakin:
        rollout_fn = compile_rollout(
            fabric, make_recurrent_rollout_fn(
                venv, agent.step, lambda out, noise: _sample(out, actions_dim, is_continuous, noise),
                lambda a: one_hot_actions(a, actions_dim, is_continuous), mlp_keys=mlp_keys, action_space=act_space,
                gamma=gamma, rollout_steps=rollout_steps),
            player_gen, venv.generator, name=f"{cfg.algo.name}.rollout", max_recompiles=max_recompiles,
            eager_reason="the recurrent Anakin phase is captured with its update (ROADMAP.md, queue A item 3(a))")
        actor = init_actor_state(venv, start_iter - 1,
                                 {"carry": carry, "prev_actions": prev_actions, "is_first": is_first})
    else:
        rb = ReplayBuffer(rollout_steps, num_envs, memmap=False, obs_keys=mlp_keys)
        obs, _ = envs.reset(seed=int(cfg.seed))
    last_losses = None
    # buffer.transfer_guard: an update past the first that waits on the host raises
    guard_on = bool(cfg.buffer.get("transfer_guard", False))

    for update in range(start_iter, total_iters + 1):
        if use_anakin:
            with timer("Time/train_time"):
                apply_schedules(actor["update"])
                with steady_guard(guard_on and update > start_iter):
                    actor, rollout, init_carry, last_v, ep_stats = rollout_fn(actor, player_gen)
                    last_losses = train_phase(rollout, init_carry, last_v, train_gen, ent_coef)
                del rollout
            policy_step += policy_steps_per_iter
            if cfg.metric.log_level > 0:
                for ep_ret, ep_len in zip(*episode_stats_from_device(ep_stats)):
                    aggregator.update("Rewards/rew_avg", float(ep_ret))
                    aggregator.update("Game/ep_len_avg", int(ep_len))
        else:
            init_carry = carry
            with timer("Time/env_interaction_time"):
                for _ in range(rollout_steps):
                    policy_step += num_envs
                    with torch.no_grad():
                        step_obs = flat_obs(obs, mlp_keys, player_device)
                        next_carry, (actor_out, _) = player_step(carry, step_obs, prev_actions, is_first)
                        actions, logprobs = _sample(actor_out, actions_dim, is_continuous, player_gen)
                    actions_np = actions.cpu().numpy()
                    next_obs, rewards, terminated, truncated, info = envs.step(actions_for_env(actions_np, act_space))
                    dones = np.logical_or(terminated, truncated)
                    rewards = np.asarray(rewards, np.float32)
                    one_hot = one_hot_actions(actions, actions_dim, is_continuous)

                    # truncation bootstrap from the post-step carry, on the full env batch
                    if np.any(truncated):
                        final_obs = final_obs_rows(info, np.nonzero(truncated)[0], mlp_keys)
                        if final_obs is not None:
                            padded = {k: np.asarray(next_obs[k], np.float32).reshape(num_envs, -1).copy()
                                      for k in mlp_keys}
                            for k in mlp_keys:
                                padded[k][truncated] = np.asarray(final_obs[k], np.float32).reshape(
                                    int(truncated.sum()), -1)
                            with torch.no_grad():
                                _, (_, v_boot) = player.step(next_carry, flat_obs(padded, mlp_keys, player_device),
                                                             one_hot, torch.zeros_like(is_first))
                            rewards[truncated] += gamma * v_boot[..., 0].cpu().numpy()[truncated]

                    step = {"actions": actions_np[None], "logprobs": logprobs.cpu().numpy()[None],
                            "rewards": rewards[None], "dones": dones.astype(np.float32)[None],
                            "is_first": is_first.cpu().numpy()[None, :, 0],
                            "prev_actions": prev_actions.cpu().numpy()[None]}
                    for k in mlp_keys:
                        step[k] = np.asarray(obs[k], np.float32).reshape(1, num_envs, -1)
                    rb.add({k: v[..., None] if v.ndim == 2 else v for k, v in step.items()})

                    obs, carry = next_obs, next_carry
                    done_rows = torch.from_numpy(dones).to(player_device)
                    prev_actions = torch.where(done_rows[:, None], torch.zeros_like(one_hot), one_hot)
                    is_first = done_rows[:, None].to(torch.float32)
                    for ep_ret, ep_len in episode_stats(info):
                        aggregator.update("Rewards/rew_avg", ep_ret)
                        aggregator.update("Game/ep_len_avg", ep_len)

            with timer("Time/train_time"):
                dev = fabric.device
                local = rb.buffer
                host = {k: np.asarray(local[k], np.float32) for k in (*mlp_keys, "actions", "prev_actions", "is_first")}
                for k in ("logprobs", "rewards", "dones"):
                    host[k] = local[k][..., 0]
                rollout = stage_rollout(host, dev)
                # bootstrap values of the state after the rollout, with the rollout's weights
                with torch.no_grad():
                    _, (_, last_v) = player.step(carry, flat_obs(obs, mlp_keys, player_device), prev_actions, is_first)
                carry0, last_v = tuple(c.to(dev) for c in init_carry), last_v[..., 0].to(dev)
                ent = stage_scalar(ent_coef, dev)
                with steady_guard(guard_on and update > start_iter):
                    last_losses = train_phase(rollout, carry0, last_v, train_gen, ent)
                del rollout
                if player is not agent:
                    player.load_state_dict(agent.state_dict())

            apply_schedules(update)

        if cfg.metric.log_level > 0 and (
            policy_step - last_log >= cfg.metric.log_every or update == total_iters or cfg.dry_run
        ):
            if last_losses is not None:
                for name, value in zip(("Loss/policy_loss", "Loss/value_loss", "Loss/entropy_loss"), last_losses):
                    aggregator.update(name, float(value))
            last_log = flush_metrics(aggregator, timer, logger, policy_step, last_log)

        if ckpt_mgr.should_save(policy_step, last_checkpoint, final=update == total_iters):
            last_checkpoint = policy_step
            ckpt_mgr.save(policy_step, {
                "agent": agent.state_dict(),
                "opt_state": optimizer.state_dict(),
                "generators": {name: gen.get_state() for name, gen in generators.items()},
                "update": update,
                "policy_step": policy_step,
                "last_log": last_log,
                "last_checkpoint": last_checkpoint,
            })
            if ckpt_mgr.preempted:
                print(f"Preemption: committed checkpoint at step {policy_step}, exiting", flush=True)
                break

    if envs is not None:
        envs.close()
    ckpt_mgr.finalize()
    if cfg.algo.run_test and not ckpt_mgr.preempted:
        test(player, cfg, log_dir, logger)
    if logger is not None:
        logger.close()
