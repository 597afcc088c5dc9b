"""PPO on one device (counterpart of ``sheeprl_tpu/algos/ppo/ppo.py``, its
host path), and the on-policy loop PPO and A2C share.

One iteration of :func:`on_policy_loop`:

* a rollout of ``algo.rollout_steps`` env steps with the player on
  ``algo.player.device`` (the card by default), acting with the current
  weights; a truncated episode's reward takes ``γ·V(final obs)``;
* the trainer's ``train_phase`` on the rollout, staged to the device
  explicitly (``data/device_replay.stage_rollout``, the annealed
  coefficients by ``stage_scalar``); with ``buffer.transfer_guard`` every
  train phase after the run's first runs under ``steady_guard``, where a
  call that waits on the host raises.  :meth:`PPOTrainer.train_phase`
  recomputes the values in one batched forward, runs GAE, then
  ``update_epochs`` × ``num_minibatches`` clipped-PPO steps over the
  minibatch order of :func:`epoch_permutation` (drawn from the train
  generator, or handed in as tensors);
* the ``anneal_lr`` / ``anneal_clip_coef`` / ``anneal_ent_coef`` schedules
  the trainer takes, logging and checkpoints (resumable: agent, optimizer,
  both generators, counters), and after the last iteration the test episode.

On a device env (``env=jax_*``; ``algo.anakin``, see
:func:`~sheeprl_tpu_torch.envs.device.registry.anakin_enabled`) the rollout
is the Anakin one (:mod:`~sheeprl_tpu_torch.envs.device.anakin`): the envs
step on the run's device inside the iteration, the schedules are taken from
the actor's update counter before the rollout, and the rollout goes to the
same ``train_phase`` on the device; ``buffer.transfer_guard`` guards the
rollout and the train phase together, as the JAX package guards its one
Anakin dispatch.  Every route goes through ``fabric.compile``: PPO's Anakin
rollout is one captured CUDA graph on the card
(:func:`~sheeprl_tpu_torch.envs.device.anakin.compile_rollout`); the
update, the host path's player and A2C's rollout run eagerly under the
same recompile audit, each with its reason at the call site.

With ``population.size > 1`` (Anakin only, as in JAX) the loop trains a
population: :class:`~sheeprl_tpu_torch.algos.ppo.population.PopulationRoute`
runs every member's rollout and update and the in-trace PBT step as one
population phase, captured as one CUDA graph on the card; checkpoints hold
the stacked parameters and optimizer state and the PBT carry, the run
writes ``population_summary.json`` and tests its fittest member.  The
decoupled PPO of ``exp=ppo_decoupled`` is
:mod:`~sheeprl_tpu_torch.algos.ppo.ppo_decoupled`, on :func:`host_rollout`
and :class:`PPOTrainer`.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, Sequence, Tuple, Union

import numpy as np
import torch

from sheeprl_tpu_torch import telemetry
from sheeprl_tpu_torch.algos.ppo.agent import build_agent, evaluate_actions, sample_actions
from sheeprl_tpu_torch.algos.ppo.loss import entropy_loss, policy_loss, value_loss
from sheeprl_tpu_torch.algos.ppo.population import NO_ANAKIN, PopulationRoute, population_size
from sheeprl_tpu_torch.algos.ppo.utils import (
    actions_for_env,
    merge_image_stack,
    normalize_obs_keys,
    prepare_obs,
    spaces_to_dims,
    test,
)
from sheeprl_tpu_torch.convert import load_resume_state, restore_generators
from sheeprl_tpu_torch.data.buffers import ReplayBuffer
from sheeprl_tpu_torch.data.device_replay import stage_rollout, stage_scalar, steady_guard
from sheeprl_tpu_torch.envs.device import anakin_enabled, vector_env_from_cfg
from sheeprl_tpu_torch.envs.device.anakin import (
    compile_rollout,
    episode_stats_from_device,
    init_actor_state,
    make_rollout_fn,
)
from sheeprl_tpu_torch.utils.env import episode_stats, final_obs_rows, make_env, vectorize
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, flush_metrics
from sheeprl_tpu_torch.utils.profiler import ProfilerGate
from sheeprl_tpu_torch.utils.optim import ClippedOptimizer, build_optimizer, set_learning_rate
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.timer import timer
from sheeprl_tpu_torch.utils.utils import gae, normalize_tensor, polynomial_decay, save_configs

Rollout = Dict[str, torch.Tensor]
Permutations = Union[torch.Generator, Sequence[torch.Tensor]]


def pad_permutation(perm: torch.Tensor, total: int) -> torch.Tensor:
    """``perm`` padded by wrap-around to ``total`` entries."""
    pad = total - perm.shape[0]
    return torch.cat([perm, perm[:pad]]) if pad > 0 else perm


def epoch_permutation(generator: torch.Generator, T: int, B: int, batch_size: int,
                      num_minibatches: int) -> torch.Tensor:
    """Flat sample order of one epoch over the ``(T, B)`` rollout: one
    permutation of the ``T·B`` rows, padded by wrap-around to
    ``num_minibatches`` consecutive slices of ``batch_size``."""
    perm = torch.randperm(T * B, generator=generator, device=generator.device)
    return pad_permutation(perm, num_minibatches * batch_size)


class OnPolicyTrainer:
    """What the PPO and A2C updates share: the agent and its optimizer, the
    values of the current weights and GAE over a rollout.

    ``rollout`` holds ``(T, B, ...)`` tensors on the agent's device: each
    observation key (as :func:`prepare_obs` lays it out), ``actions``
    ``(T, B, n)``, ``logprobs``, ``rewards`` and ``dones`` ``(T, B)``;
    ``last_obs`` the ``(B, ...)`` observations after the last step."""

    #: the coefficients :func:`on_policy_loop` anneals when the config asks
    SCHEDULES: Tuple[str, ...] = ("lr",)
    #: whether the update reads the rollout's log-probs
    STORES_LOGPROBS = True
    #: why the loop runs the Anakin rollout eagerly on the card (None: captured)
    ROLLOUT_EAGER_REASON: Any = "A2C's Anakin phase is captured with its update (ROADMAP.md, queue A item 3(a))"

    def __init__(self, cfg: Any, agent: torch.nn.Module, optimizer: ClippedOptimizer, obs_keys: Sequence[str],
                 actions_dim: Sequence[int], is_continuous: bool, T: int, B: int):
        a = cfg.algo
        self.agent, self.optimizer = agent, optimizer
        self.obs_keys, self.actions_dim, self.is_continuous = tuple(obs_keys), tuple(actions_dim), is_continuous
        self.dist_type = cfg.get("distribution", {}).get("type", "auto")
        self.reduction = a.loss_reduction
        self.vf_coef, self.gamma, self.gae_lambda = float(a.vf_coef), float(a.gamma), float(a.gae_lambda)
        self.T, self.B = T, B

    def values(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.no_grad():
            return self.agent(obs)[1][..., 0]

    def flat_rollout(self, rollout: Rollout, last_obs: Dict[str, torch.Tensor]) -> Rollout:
        """The rollout as ``T·B`` rows with the values of the current weights,
        the returns and the advantages."""
        T, B = rollout["rewards"].shape
        flat = {k: rollout[k].reshape(T * B, *rollout[k].shape[2:]) for k in self.obs_keys}
        values = self.values(flat).reshape(T, B)
        returns, advantages = gae(rollout["rewards"], values, rollout["dones"], self.values(last_obs), self.gamma,
                                  self.gae_lambda)
        flat.update(actions=rollout["actions"].reshape(T * B, -1), values=values.reshape(T * B),
                    returns=returns.reshape(T * B), advantages=advantages.reshape(T * B))
        if "logprobs" in rollout:
            flat["logprobs"] = rollout["logprobs"].reshape(T * B)
        return flat

    def step(self, loss: torch.Tensor) -> None:
        self.optimizer.zero_grad()
        loss.backward()
        self.optimizer.step()

    def checkpoint_extras(self) -> Dict[str, Any]:
        return {}


class PPOTrainer(OnPolicyTrainer):
    """The PPO update of one rollout: values, GAE, then epochs of clipped
    minibatch steps."""

    SCHEDULES = ("lr", "clip_coef", "ent_coef")
    ROLLOUT_EAGER_REASON = None

    def __init__(self, cfg: Any, *args: Any):
        super().__init__(cfg, *args)
        a = cfg.algo
        self.clip_vloss, self.normalize_adv = bool(a.clip_vloss), bool(a.normalize_advantages)
        self.update_epochs = int(a.update_epochs)
        self.batch_size = min(int(a.per_rank_batch_size), self.T * self.B)
        self.num_minibatches = -(-self.T * self.B // self.batch_size)  # ceil: the tail is padded, not dropped

    def loss(self, batch: Rollout, clip_coef: Any, ent_coef: Any, agent: Any = None):
        """The clipped-PPO loss of one minibatch and its (policy, value,
        entropy) parts; ``agent`` replaces ``self.agent`` (a population runs
        one member's parameters through it)."""
        out, new_values = (agent or self.agent)({k: batch[k] for k in self.obs_keys})
        new_logprobs, entropy = evaluate_actions(out, batch["actions"], self.actions_dim, self.is_continuous,
                                                 self.dist_type)
        adv = normalize_tensor(batch["advantages"]) if self.normalize_adv else batch["advantages"]
        pg = policy_loss(new_logprobs, batch["logprobs"], adv, clip_coef, self.reduction)
        vl = value_loss(new_values[..., 0], batch["values"], batch["returns"], clip_coef, self.clip_vloss,
                        self.reduction)
        ent = entropy_loss(entropy, self.reduction)
        return pg + self.vf_coef * vl + ent_coef * ent, (pg, vl, ent)

    def train_phase(self, rollout: Rollout, last_obs: Dict[str, torch.Tensor], perms: Permutations,
                    clip_coef: float, ent_coef: float) -> Tuple[torch.Tensor, ...]:
        """GAE and every epoch of minibatch steps; ``perms`` is the train
        generator (one :func:`epoch_permutation` per epoch) or the epochs'
        sample orders.  Returns the last step's (policy, value, entropy) losses."""
        flat = self.flat_rollout(rollout, last_obs)
        losses = None
        for epoch in range(self.update_epochs):
            perm = (epoch_permutation(perms, self.T, self.B, self.batch_size, self.num_minibatches)
                    if isinstance(perms, torch.Generator) else perms[epoch])
            for i in range(self.num_minibatches):
                idx = perm[i * self.batch_size:(i + 1) * self.batch_size]
                loss, losses = self.loss({k: v[idx] for k, v in flat.items()}, clip_coef, ent_coef)
                self.step(loss)
        return tuple(x.detach() for x in losses)

    def checkpoint_extras(self) -> Dict[str, Any]:
        return {"batch_size": self.batch_size}


def rollout_to_device(buffer: Dict[str, np.ndarray], cnn_keys: Sequence[str], mlp_keys: Sequence[str],
                      device: Any) -> Rollout:
    """A host rollout ring ``(T, B, ...)`` → the trainer's tensors, staged
    explicitly (``stage_rollout``): images moved as bytes and scaled on
    ``device``, the per-step scalars squeezed to ``(T, B)``."""
    host = {k: merge_image_stack(buffer[k], rollout=True) for k in cnn_keys}
    host.update({k: np.asarray(buffer[k], np.float32) for k in mlp_keys})
    host["actions"] = np.asarray(buffer["actions"])
    for k in ("logprobs", "rewards", "dones"):
        host[k] = np.asarray(buffer[k])[..., 0]
    out = stage_rollout(host, device)
    for k in cnn_keys:
        out[k] = out[k].to(torch.float32) / 255.0
    return out


def host_rollout(envs: Any, rb: ReplayBuffer, obs: Dict[str, np.ndarray], act: Any, values: Any,
                 rollout_steps: int, obs_keys: Sequence[str], act_space: Any, gamma: float,
                 aggregator: MetricAggregator) -> Dict[str, np.ndarray]:
    """``rollout_steps`` steps of the host envs into ``rb``, from ``obs``;
    returns the observations after the last step.  ``act(obs)`` gives the
    player's actions and log-probs, ``values(obs)`` its values (numpy).  A
    truncated episode's reward takes ``γ·V(final obs)``."""
    for _ in range(rollout_steps):
        actions_np, logprobs_np = act(obs)
        next_obs, rewards, terminated, truncated, info = envs.step(actions_for_env(actions_np, act_space))
        dones = np.logical_or(terminated, truncated)
        rewards = np.asarray(rewards, np.float32)

        # truncation bootstrap: r += γ·V(real final obs), on the full env batch
        if np.any(truncated):
            final_obs = final_obs_rows(info, np.nonzero(truncated)[0], obs_keys)
            if final_obs is not None:
                padded = {k: np.asarray(next_obs[k]).copy() for k in obs_keys}
                for k in obs_keys:
                    padded[k][truncated] = final_obs[k]
                rewards[truncated] += gamma * values(padded)[truncated]

        step_data = {k: np.asarray(obs[k])[None] for k in obs_keys}
        step_data["actions"] = actions_np[None]
        step_data["logprobs"] = logprobs_np[None]
        step_data["rewards"] = rewards[None]
        step_data["dones"] = dones[None].astype(np.float32)
        rb.add({k: v[..., None] if v.ndim == 2 else v for k, v in step_data.items()})
        obs = next_obs
        for ep_ret, ep_len in episode_stats(info):
            aggregator.update("Rewards/rew_avg", ep_ret)
            aggregator.update("Game/ep_len_avg", ep_len)
    return obs


def on_policy_loop(fabric: Any, cfg: Any, trainer_cls: Any) -> None:
    """The env / rollout / update loop of PPO and A2C on one device; the
    trainer class (``trainer_cls(cfg, agent, optimizer, obs_keys,
    actions_dim, is_continuous, T, B)``) is the update."""
    use_anakin = anakin_enabled(cfg)
    pop_size = population_size(cfg)
    if pop_size > 1 and not use_anakin:
        raise ValueError(NO_ANAKIN)
    # the Anakin rollout acts with the trained agent itself, on the run's device
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
        if pop_size > 1:
            where = f"a population of {pop_size} members, each {where}"
    else:
        envs = vectorize(cfg, [make_env(cfg, cfg.seed + i, 0, run_name=log_dir, vector_env_idx=i)
                               for i in range(num_envs)])
        obs_space, act_space = envs.single_observation_space, envs.single_action_space
        where = f"player on {player_device}, {envs.describe()}"
    normalize_obs_keys(cfg, obs_space)
    actions_dim, is_continuous = spaces_to_dims(act_space)
    cnn_keys, mlp_keys = tuple(cfg.algo.cnn_keys.encoder), tuple(cfg.algo.mlp_keys.encoder)
    obs_keys = cnn_keys + mlp_keys
    dist_type = cfg.get("distribution", {}).get("type", "auto")
    print(f"{cfg.algo.name} on {fabric.device}: {where}", flush=True)

    state: Dict[str, Any] = {}
    if cfg.checkpoint.get("resume_from"):
        state = load_resume_state(cfg.checkpoint.resume_from, cfg)
    restore_generators(state, generators)
    rollout_steps = int(cfg.algo.rollout_steps)
    start_iter = int(state.get("update", 0)) + 1 if state else 1
    max_recompiles = cfg.algo.get("max_recompiles")
    population = None
    if pop_size > 1:
        # every member trains on its own env shard in one population phase
        population = PopulationRoute(fabric, cfg, trainer_cls, venv.env, obs_space, act_space, actions_dim,
                                     is_continuous, generators, state, start_iter, max_recompiles)
        telemetry.HUB.register("population", population.monitor)
    else:
        agent = build_agent(fabric, actions_dim, is_continuous, cfg, obs_space, state.get("agent"))
        optimizer = build_optimizer(agent.named_parameters(), cfg.algo.optimizer, cfg.algo.max_grad_norm)
        if state.get("opt_state") is not None:
            optimizer.load_state_dict(state["opt_state"])
        trainer = trainer_cls(cfg, agent, optimizer, obs_keys, actions_dim, is_continuous, rollout_steps, num_envs)
        # on-policy: the player acts with the current weights, refreshed after every update
        player = agent if player_device == fabric.device else copy.deepcopy(agent).to(player_device)

    aggregator = MetricAggregator(cfg.metric.aggregator.metrics if cfg.metric.log_level > 0 else {})
    timer.configure(cfg.metric)

    # every member steps its own env shard: a population multiplies the env
    # steps of an iteration, so total_steps buys fewer iterations
    policy_steps_per_iter = num_envs * rollout_steps * max(pop_size, 1)
    total_iters = 1 if cfg.dry_run else max(int(cfg.algo.total_steps) // policy_steps_per_iter, 1)
    policy_step = int(state.get("policy_step", 0))
    last_log = int(state.get("last_log", 0))
    last_checkpoint = int(state.get("last_checkpoint", 0))
    gamma = float(cfg.algo.gamma)
    base_lr = float(cfg.algo.optimizer.lr)
    initial = {"clip_coef": float(cfg.algo.get("clip_coef", 0.0)), "ent_coef": float(cfg.algo.ent_coef)}
    coef = dict(initial)

    def apply_schedules(step: int) -> None:
        """The annealed learning rate and coefficients at ``step`` updates."""
        if cfg.algo.anneal_lr and "lr" in trainer.SCHEDULES:
            set_learning_rate(optimizer, polynomial_decay(step, initial=base_lr, final=0.0,
                                                          max_decay_steps=total_iters, power=1.0))
        for name in ("clip_coef", "ent_coef"):
            if cfg.algo.get(f"anneal_{name}", False) and name in trainer.SCHEDULES:
                coef[name] = polynomial_decay(step, initial=initial[name], final=0.0, max_decay_steps=total_iters)

    last_losses = None
    # buffer.transfer_guard: an update past the first that waits on the host raises
    guard_on = bool(cfg.buffer.get("transfer_guard", False))
    if population is None:
        # the update runs eagerly: the learning rate and the annealed coefficients
        # are Python values a graph would freeze (GAE and the update: ROADMAP.md,
        # queue A item 3(a))
        train_phase = fabric.compile(trainer.train_phase, name=f"{cfg.algo.name}.train_phase",
                                     max_recompiles=max_recompiles,
                                     eager_reason="the annealed learning rate and coefficients are Python values")
        if use_anakin:
            rollout_fn = compile_rollout(
                fabric, make_rollout_fn(
                    venv, agent, lambda out, noise: sample_actions(out, actions_dim, is_continuous, noise,
                                                                    dist_type=dist_type),
                    cnn_keys=cnn_keys, mlp_keys=mlp_keys, action_space=act_space, gamma=gamma,
                    rollout_steps=rollout_steps, store_logprobs=trainer_cls.STORES_LOGPROBS),
                player_gen, venv.generator, name=f"{cfg.algo.name}.rollout", max_recompiles=max_recompiles,
                eager_reason=trainer_cls.ROLLOUT_EAGER_REASON)
            actor = init_actor_state(venv, start_iter - 1)
        else:
            memmap_dir = os.path.join(log_dir, "memmap_buffer", "rank_0") if cfg.buffer.memmap else None
            rb = ReplayBuffer(rollout_steps, num_envs, memmap=cfg.buffer.memmap, memmap_dir=memmap_dir,
                              obs_keys=obs_keys)
            obs, _ = envs.reset(seed=int(cfg.seed))

        def player_act(o: Dict[str, torch.Tensor]):
            out, _ = player(o)
            return sample_actions(out, actions_dim, is_continuous, player_gen, dist_type=dist_type)

        # the host path's player: one step per env step, synchronised by the copy
        # of its actions to the env; it runs eagerly under the audit
        player_step = fabric.compile(player_act, name=f"{cfg.algo.name}.player_step", device=player_device,
                                     max_recompiles=max_recompiles,
                                     eager_reason="the host loop copies every step's actions to the env")

        def player_act_np(o: Dict[str, np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
            with torch.inference_mode():
                actions, logprobs, _ = player_step(prepare_obs(o, cnn_keys, mlp_keys, player_device))
            return actions.cpu().numpy(), logprobs.cpu().numpy()

        def player_values(o: Dict[str, np.ndarray]) -> np.ndarray:
            with torch.inference_mode():
                return player(prepare_obs(o, cnn_keys, mlp_keys, player_device))[1][..., 0].cpu().numpy()

    profiler = ProfilerGate(cfg, log_dir)
    for update in range(start_iter, total_iters + 1):
        profiler.step(update)
        if population is not None:
            # every member's rollout and update and the PBT step: one population phase
            with timer("Time/train_time"):
                with steady_guard(guard_on and update > start_iter):
                    member_losses, ep_stats = population.step()
            policy_step += policy_steps_per_iter
            if cfg.metric.log_level > 0:
                for ep_ret, ep_len in zip(*episode_stats_from_device(ep_stats)):
                    aggregator.update("Rewards/rew_avg", float(ep_ret))
                    aggregator.update("Game/ep_len_avg", int(ep_len))
                population.observe()
        elif use_anakin:
            # the env steps inside the iteration: the rollout and the update are one train time
            with timer("Time/train_time"):
                apply_schedules(actor["update"])
                with steady_guard(guard_on and update > start_iter):
                    actor, rollout, last_obs, ep_stats = rollout_fn(actor, player_gen)
                    last_losses = train_phase(rollout, last_obs, train_gen, coef["clip_coef"], coef["ent_coef"])
                del rollout, last_obs
            policy_step += policy_steps_per_iter
            if cfg.metric.log_level > 0:
                for ep_ret, ep_len in zip(*episode_stats_from_device(ep_stats)):
                    aggregator.update("Rewards/rew_avg", float(ep_ret))
                    aggregator.update("Game/ep_len_avg", int(ep_len))
        else:
            with timer("Time/env_interaction_time"):
                obs = host_rollout(envs, rb, obs, player_act_np, player_values, rollout_steps, obs_keys, act_space,
                                   gamma, aggregator)
                policy_step += num_envs * rollout_steps

            with timer("Time/train_time"):
                rollout = rollout_to_device(rb.buffer, cnn_keys, mlp_keys, fabric.device)
                last_obs = prepare_obs(obs, cnn_keys, mlp_keys, fabric.device)
                clip_coef, ent_coef = (stage_scalar(coef[k], fabric.device) for k in ("clip_coef", "ent_coef"))
                with steady_guard(guard_on and update > start_iter):
                    last_losses = train_phase(rollout, last_obs, train_gen, clip_coef, ent_coef)
                del rollout, last_obs
                if player is not agent:
                    player.load_state_dict(agent.state_dict())

            # ---------------- schedules ----------------------------------------
            apply_schedules(update)

        # ---------------- logging ------------------------------------------------
        if cfg.metric.log_level > 0 and (
            policy_step - last_log >= cfg.metric.log_every or update == total_iters or cfg.dry_run
        ):
            if population is not None:
                last_losses = member_losses.mean(dim=0)  # the members' mean
            if last_losses is not None:
                for name, value in zip(("Loss/policy_loss", "Loss/value_loss", "Loss/entropy_loss"), last_losses):
                    aggregator.update(name, float(value))
            last_log = flush_metrics(aggregator, timer, logger, policy_step, last_log)

        # ---------------- checkpoint ---------------------------------------------
        if ckpt_mgr.should_save(policy_step, last_checkpoint, final=update == total_iters):
            last_checkpoint = policy_step
            if population is None:
                learner = {"agent": agent.state_dict(), "opt_state": optimizer.state_dict(),
                           **trainer.checkpoint_extras()}
            else:
                # the stacked (P, ...) parameters and optimizer state, and the PBT carry
                learner = {**population.checkpoint_state(), **population.trainer.single.checkpoint_extras()}
            ckpt_mgr.save(policy_step, {
                **learner,
                "generators": {name: gen.get_state() for name, gen in generators.items()},
                "update": update,
                "policy_step": policy_step,
                "last_log": last_log,
                "last_checkpoint": last_checkpoint,
            })
            if ckpt_mgr.preempted:
                print(f"Preemption: committed checkpoint at step {policy_step}, exiting", flush=True)
                break

    profiler.close()
    if envs is not None:
        envs.close()
    ckpt_mgr.finalize()
    if population is not None:
        population.write_summary(log_dir, policy_step)
        # the test episode runs the fittest member
        player = population.best_agent()
    if cfg.algo.run_test and not ckpt_mgr.preempted:
        test(player, cfg, log_dir, logger)
    if logger is not None:
        logger.close()


@register_algorithm()
def main(fabric: Any, cfg: Any) -> None:
    on_policy_loop(fabric, cfg, PPOTrainer)
