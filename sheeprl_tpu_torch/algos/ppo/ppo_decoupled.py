"""Decoupled PPO on one device (counterpart of the single-controller
``main`` of ``sheeprl_tpu/algos/ppo/ppo_decoupled.py``, its pipelined
topology).

The player acts with its own copy of the agent, one iteration stale.  Each
iteration, in the JAX loop's order:

1. the update of rollout *k* is issued (:class:`PPOTrainer`'s train phase:
   values, GAE, the clipped minibatch epochs);
2. rollout *k+1* is collected by the player, which still holds the weights
   trained on rollout *k-1* (the first two rollouts act with the initial
   weights); on the card the player runs on a stream of its own, so its
   steps do not queue behind the update;
3. the player is refreshed: the trained weights are copied into the
   player's own tensors.  The update writes its parameters in place, so a
   player that aliased them would silently act with current weights.

Then the annealed learning rate and coefficients at the iteration, logging
and the checkpoint (agent, optimizer, generators and counters; a resume
restarts the clip and entropy annealing, as JAX's does).  With
``algo.player.dedicated=True`` on one process the run warns as the JAX
package does and takes this loop; a wanted device split raises
(:func:`~sheeprl_tpu_torch.parallel.topology.resolve_topology`).
"""

from __future__ import annotations

import contextlib
import copy
import warnings
from typing import Any, Dict, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.ppo.agent import build_agent, sample_actions
from sheeprl_tpu_torch.algos.ppo.ppo import PPOTrainer, host_rollout, rollout_to_device
from sheeprl_tpu_torch.algos.ppo.utils import normalize_obs_keys, prepare_obs, spaces_to_dims, test
from sheeprl_tpu_torch.convert import load_resume_state, restore_generators
from sheeprl_tpu_torch.data.buffers import ReplayBuffer
from sheeprl_tpu_torch.data.device_replay import stage_scalar
from sheeprl_tpu_torch.parallel.topology import resolve_topology
from sheeprl_tpu_torch.utils.env import make_env, vectorize
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, flush_metrics
from sheeprl_tpu_torch.utils.optim import build_optimizer, set_learning_rate
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.timer import timer
from sheeprl_tpu_torch.utils.utils import polynomial_decay, save_configs

DEDICATED_FALLBACK = (
    "algo.player.dedicated=True needs >= 2 processes (jax.distributed); "
    "falling back to the single-controller pipelined topology "
    "(deprecated — prefer topology=sebulba, docs/sebulba.md)"
)


def warn_dedicated_fallback(cfg: Any) -> None:
    """``algo.player.dedicated=True`` on one process: the JAX package's
    warning; the run takes the pipelined loop."""
    if (cfg.algo.get("player", {}) or {}).get("dedicated", False):
        warnings.warn(DEDICATED_FALLBACK, UserWarning)


@register_algorithm(decoupled=True, name="ppo_decoupled")
def main(fabric: Any, cfg: Any) -> None:
    if cfg.buffer.get("share_data", False):
        warnings.warn(
            "buffer.share_data=True is ignored by decoupled PPO: the player "
            "already collects ONE global rollout that every trainer minibatches "
            "(reference: sheeprl/algos/ppo/ppo_decoupled.py:639-643)"
        )
    resolve_topology(cfg, fabric)
    warn_dedicated_fallback(cfg)
    player_device = fabric.player_device(cfg)
    train_gen, player_gen = fabric.seed_everything(int(cfg.seed), player_device)
    generators = {"train": train_gen, "player": player_gen}

    log_dir = get_log_dir(cfg.root_dir, cfg.run_name, base=cfg.get("log_dir", "logs/runs"))
    logger = get_logger(cfg, log_dir)
    ckpt_mgr = fabric.get_checkpoint_manager(cfg, log_dir)
    save_configs(cfg, log_dir)

    num_envs = int(cfg.env.num_envs)
    envs = vectorize(cfg, [make_env(cfg, cfg.seed + i, 0, run_name=log_dir, vector_env_idx=i)
                           for i in range(num_envs)])
    obs_space, act_space = envs.single_observation_space, envs.single_action_space
    normalize_obs_keys(cfg, obs_space)
    actions_dim, is_continuous = spaces_to_dims(act_space)
    cnn_keys, mlp_keys = tuple(cfg.algo.cnn_keys.encoder), tuple(cfg.algo.mlp_keys.encoder)
    obs_keys = cnn_keys + mlp_keys
    dist_type = cfg.get("distribution", {}).get("type", "auto")
    print(f"{cfg.algo.name} on {fabric.device}: pipelined, player on {player_device} one iteration stale, "
          f"{envs.describe()}", flush=True)

    state: Dict[str, Any] = {}
    if cfg.checkpoint.get("resume_from"):
        state = load_resume_state(cfg.checkpoint.resume_from, cfg)
    restore_generators(state, generators)
    agent = build_agent(fabric, actions_dim, is_continuous, cfg, obs_space, state.get("agent"))
    optimizer = build_optimizer(agent.named_parameters(), cfg.algo.optimizer, cfg.algo.max_grad_norm)
    if state.get("opt_state") is not None:
        optimizer.load_state_dict(state["opt_state"])
    rollout_steps = int(cfg.algo.rollout_steps)
    trainer = PPOTrainer(cfg, agent, optimizer, obs_keys, actions_dim, is_continuous, rollout_steps, num_envs)
    # the player's own tensors: refreshed by copies, never aliasing the trained ones
    player = copy.deepcopy(agent).to(player_device).requires_grad_(False)
    player_stream = None
    if player_device.type == "cuda":
        player_stream = torch.cuda.Stream(player_device)
        player_stream.wait_stream(torch.cuda.current_stream(player_device))

    aggregator = MetricAggregator(cfg.metric.aggregator.metrics if cfg.metric.log_level > 0 else {})
    timer.configure(cfg.metric)

    max_recompiles = cfg.algo.get("max_recompiles")
    train_phase = fabric.compile(trainer.train_phase, name=f"{cfg.algo.name}.train_phase",
                                 max_recompiles=max_recompiles,
                                 eager_reason="the annealed learning rate and coefficients are Python values")

    def player_act(o: Dict[str, torch.Tensor]):
        out, _ = player(o)
        return sample_actions(out, actions_dim, is_continuous, player_gen, dist_type=dist_type)

    player_step = fabric.compile(player_act, name=f"{cfg.algo.name}.player_step", device=player_device,
                                 max_recompiles=max_recompiles,
                                 eager_reason="the host loop copies every step's actions to the env")

    def on_player_stream():
        return torch.cuda.stream(player_stream) if player_stream is not None else contextlib.nullcontext()

    def act(o: Dict[str, np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        with on_player_stream(), torch.inference_mode():
            actions, logprobs, _ = player_step(prepare_obs(o, cnn_keys, mlp_keys, player_device))
            return actions.cpu().numpy(), logprobs.cpu().numpy()

    def values(o: Dict[str, np.ndarray]) -> np.ndarray:
        with on_player_stream(), torch.inference_mode():
            return player(prepare_obs(o, cnn_keys, mlp_keys, player_device))[1][..., 0].cpu().numpy()

    policy_steps_per_iter = num_envs * rollout_steps
    total_iters = 1 if cfg.dry_run else max(int(cfg.algo.total_steps) // policy_steps_per_iter, 1)
    start_iter = int(state.get("update", 0)) + 1 if state else 1
    policy_step = int(state.get("policy_step", 0))
    last_log = int(state.get("last_log", 0))
    last_checkpoint = int(state.get("last_checkpoint", 0))
    gamma = float(cfg.algo.gamma)
    base_lr = float(cfg.algo.optimizer.lr)
    clip_coef, ent_coef = float(cfg.algo.clip_coef), float(cfg.algo.ent_coef)
    rb = ReplayBuffer(rollout_steps, num_envs, memmap=False, obs_keys=obs_keys)

    def collect(obs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        nonlocal policy_step
        with timer("Time/env_interaction_time"):
            obs = host_rollout(envs, rb, obs, act, values, rollout_steps, obs_keys, act_space, gamma, aggregator)
        policy_step += policy_steps_per_iter
        return obs

    obs, _ = envs.reset(seed=int(cfg.seed))
    obs = collect(obs)
    last_losses = None
    for update in range(start_iter, total_iters + 1):
        # 1. the update of rollout k, issued
        with timer("Time/train_time"):
            rollout = rollout_to_device(rb.buffer, cnn_keys, mlp_keys, fabric.device)
            last_obs = prepare_obs(obs, cnn_keys, mlp_keys, fabric.device)
            last_losses = train_phase(rollout, last_obs, train_gen, stage_scalar(clip_coef, fabric.device),
                                      stage_scalar(ent_coef, fabric.device))
            del rollout, last_obs
        # 2. rollout k+1 with the player's weights of k-1, while the card trains
        if update < total_iters:
            obs = collect(obs)
        # 3. the player takes the trained weights, by copy
        with torch.no_grad():
            player.load_state_dict(agent.state_dict())
        if player_stream is not None:
            player_stream.wait_stream(torch.cuda.current_stream(player_device))

        # schedules (JAX: after the refresh, at the iteration just trained)
        if cfg.algo.anneal_lr:
            set_learning_rate(optimizer, polynomial_decay(update, initial=base_lr, final=0.0,
                                                          max_decay_steps=total_iters))
        if cfg.algo.anneal_clip_coef:
            clip_coef = polynomial_decay(update, initial=float(cfg.algo.clip_coef), final=0.0,
                                         max_decay_steps=total_iters)
        if cfg.algo.anneal_ent_coef:
            ent_coef = polynomial_decay(update, initial=float(cfg.algo.ent_coef), final=0.0,
                                        max_decay_steps=total_iters)

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

    envs.close()
    ckpt_mgr.finalize()
    if cfg.algo.run_test and not ckpt_mgr.preempted:
        test(player, cfg, log_dir, logger)
    if logger is not None:
        logger.close()
