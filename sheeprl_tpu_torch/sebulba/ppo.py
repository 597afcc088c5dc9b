"""Sebulba PPO (counterpart of ``sheeprl_tpu/sebulba/ppo.py``): decoupled PPO
on the actor/learner split (``topology=sebulba``), both roles on the one
device.

* **host envs**: ``topology.env_workers`` worker threads step env slices
  (worker processes under ``env.sync_env=False``) and round-trip
  observation blocks through the actor's batched engine
  (:class:`~sheeprl_tpu_torch.sebulba.actor.ActorEngine`); each worker
  assembles ``(T, B_w)`` segments and pushes them into the trajectory queue.
* **device envs** (``env=jax_*``): the actor runs the Anakin rollout
  (:class:`~sheeprl_tpu_torch.sebulba.actor.FusedActor`), one captured graph
  of the rollout and its truncation bootstrap on the card.
* **learner**: pops one segment per producer, concatenates them along the
  env axis and runs :class:`~sheeprl_tpu_torch.algos.ppo.ppo.PPOTrainer`'s
  train phase (values, GAE, every epoch of minibatches) through
  ``fabric.compile``, eagerly for the same reason as decoupled PPO; then
  publishes the weights to the actors under the staleness gate.

The learner runs on the calling thread, the actors and workers on threads
of their own.  The order of publish, gate and check, the annealing, the
checkpoint's counters, the hub sources and the span window are JAX's.  The
actors' draws come from generators of their own (JAX folds each actor's key
from the run's; no generator reproduces threefry); the learner's minibatch
orders from the run's train generator.
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.ppo.agent import build_agent, sample_actions
from sheeprl_tpu_torch.algos.ppo.ppo import PPOTrainer, Permutations
from sheeprl_tpu_torch.algos.ppo.utils import actions_for_env, normalize_obs_keys, obs_to_np, spaces_to_dims, test
from sheeprl_tpu_torch.convert import load_resume_state, restore_generators
from sheeprl_tpu_torch.data.device_replay import stage_scalar
from sheeprl_tpu_torch.envs.device.registry import is_native, vector_env_from_cfg
from sheeprl_tpu_torch.parallel.topology import DeviceTopology, ParamBroadcast, topology_cfg
from sheeprl_tpu_torch.sebulba.actor import (
    ActorEngine,
    EnvWorker,
    FusedActor,
    WindowGuard,
    WorkerSupervisor,
    derive_ladder,
)
from sheeprl_tpu_torch.sebulba.queues import ObsQueue, TrajQueue
from sheeprl_tpu_torch.sebulba.runner import (
    StatsSink,
    arm_preemption,
    build_worker_fleet,
    clamp_queue_slots,
    collect_run_stats,
    drain_preemptible,
    shutdown,
)
from sheeprl_tpu_torch.utils.env import episode_stats, final_obs_rows, make_env
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, flush_metrics
from sheeprl_tpu_torch.utils.optim import build_optimizer, set_learning_rate
from sheeprl_tpu_torch.utils.timer import timer
from sheeprl_tpu_torch.utils.utils import polynomial_decay, save_configs

#: the seed offset of actor ``i``'s generator (JAX folds ``0xF0 + i`` into the run's key)
ACTOR_SEED = 0xF0
ROLLOUT_KEYS = ("actions", "logprobs", "rewards", "dones")


class PPOWorkerProtocol:
    """Per-step semantics of a PPO env worker: prepared-observation blocks
    out, sampled actions back, the truncation bootstrap through a second
    inference on the final-obs block padded to the full block (same rung)."""

    def __init__(self, obs_keys, cnn_keys, mlp_keys, act_space, gamma):
        self.obs_keys = tuple(obs_keys)
        self.cnn_keys = tuple(cnn_keys)
        self.mlp_keys = tuple(mlp_keys)
        self.act_space = act_space
        self.gamma = float(gamma)

    def prepare(self, obs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = {k: obs_to_np(obs[k], is_image=True) for k in self.cnn_keys}
        out.update({k: obs_to_np(obs[k], is_image=False) for k in self.mlp_keys})
        return out

    def on_reset(self, worker: EnvWorker, obs: Dict[str, np.ndarray]) -> None:
        pass

    def run_segment(self, worker: EnvWorker, envs: Any, obs: Dict[str, np.ndarray], steps: int
                    ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray], List[Tuple[float, int]], int]:
        num_envs = envs.num_envs
        rows: Dict[str, List[np.ndarray]] = {k: [] for k in (*self.obs_keys, *ROLLOUT_KEYS)}
        ep_stats: List[Tuple[float, int]] = []
        for _ in range(steps):
            worker.beat()
            block = self.prepare(obs)
            out = worker.infer(block)
            actions = np.asarray(out["actions"])
            next_obs, rewards, terminated, truncated, info = envs.step(actions_for_env(actions, self.act_space))
            rewards = np.asarray(rewards, np.float32)
            dones = np.logical_or(terminated, truncated)
            if np.any(truncated):
                # r += γ·V(final obs), the final-obs batch padded to the full block
                final_obs = final_obs_rows(info, np.nonzero(truncated)[0], self.obs_keys)
                if final_obs is not None:
                    padded = {k: np.asarray(next_obs[k]).copy() for k in self.obs_keys}
                    for k in self.obs_keys:
                        padded[k][truncated] = final_obs[k]
                    vals = np.asarray(worker.infer(self.prepare(padded))["values"])
                    rewards[truncated] += self.gamma * vals[truncated]
            for k in self.obs_keys:
                rows[k].append(block[k])
            rows["actions"].append(actions.reshape(num_envs, -1))
            rows["logprobs"].append(np.asarray(out["logprobs"]).reshape(num_envs))
            rows["rewards"].append(rewards.reshape(num_envs))
            rows["dones"].append(dones.astype(np.float32).reshape(num_envs))
            obs = next_obs
            ep_stats.extend(episode_stats(info))
        segment = {k: np.stack(v, axis=0) for k, v in rows.items()}
        last = self.prepare(obs)
        for k in self.obs_keys:
            segment[f"last_{k}"] = last[k]
        return obs, segment, ep_stats, steps * num_envs


def make_policy(agent: torch.nn.Module, actions_dim: Sequence[int], is_continuous: bool, dist_type: str):
    """The actor engine's per-row policy on ``agent``: actions, their
    log-probs and the values; ``noise`` is the engine's generator or handed
    draws."""

    def policy(obs: Dict[str, torch.Tensor], noise: Any) -> Dict[str, torch.Tensor]:
        out, value = agent(obs)
        actions, logprob, _ = sample_actions(out, actions_dim, is_continuous, noise, dist_type=dist_type)
        return {"actions": actions, "logprobs": logprob, "values": value[..., 0]}

    return policy


def make_learner_phase(trainer: PPOTrainer, obs_keys: Sequence[str]):
    """The producers' segments concatenated along the env axis, then the
    trainer's whole train phase."""

    def learner_phase(segs: Sequence[Dict[str, torch.Tensor]], perms: Permutations, clip_coef: Any,
                      ent_coef: Any) -> Tuple[torch.Tensor, ...]:
        rollout = {k: torch.cat([s[k] for s in segs], dim=1) for k in (*obs_keys, *ROLLOUT_KEYS)}
        last_obs = {k: torch.cat([s[f"last_{k}"] for s in segs], dim=0) for k in obs_keys}
        return trainer.train_phase(rollout, last_obs, perms, clip_coef, ent_coef)

    return learner_phase


def run_sebulba(fabric: Any, cfg: Any) -> Dict[str, Any]:
    """Train decoupled PPO through the Sebulba topology; returns the run's
    stats (throughput, queue and staleness counters)."""
    from sheeprl_tpu_torch.envs.device.anakin import compile_rollout, init_actor_state, make_rollout_fn
    from sheeprl_tpu_torch.telemetry import HUB, SPANS

    topo_cfg = topology_cfg(cfg)
    topo = DeviceTopology.from_config(fabric, cfg)
    print(topo.describe(), flush=True)
    device = fabric.device
    train_gen, _ = fabric.seed_everything(int(cfg.seed), device)
    generators = {"train": train_gen}

    log_dir = get_log_dir(cfg.root_dir, cfg.run_name, base=cfg.get("log_dir", "logs/runs"))
    logger = get_logger(cfg, log_dir)
    ckpt_mgr = fabric.get_checkpoint_manager(cfg, log_dir)
    save_configs(cfg, log_dir)

    num_envs = int(cfg.env.num_envs)
    rollout_steps = int(cfg.algo.rollout_steps)
    device_envs = is_native(cfg)
    num_actors = topo.num_actors
    if device_envs:
        if num_envs % num_actors:
            raise ValueError(f"sebulba jax actors need env.num_envs ({num_envs}) divisible "
                             f"by topology.actor_devices ({num_actors})")
        venvs = [vector_env_from_cfg(cfg, d) for d in topo.actor_devices]
        obs_space, act_space = venvs[0].single_observation_space, venvs[0].single_action_space
        num_workers = num_actors
    else:
        num_workers = max(1, int(topo_cfg.get("env_workers", 2)))
        if num_envs % num_workers:
            raise ValueError(f"sebulba env workers need env.num_envs ({num_envs}) divisible "
                             f"by topology.env_workers ({num_workers})")
        probe = make_env(cfg, cfg.seed, 0, run_name=log_dir, vector_env_idx=0)()
        obs_space, act_space = probe.observation_space, probe.action_space
        probe.close()
    normalize_obs_keys(cfg, obs_space)
    actions_dim, is_continuous = spaces_to_dims(act_space)
    cnn_keys, mlp_keys = tuple(cfg.algo.cnn_keys.encoder), tuple(cfg.algo.mlp_keys.encoder)
    obs_keys = cnn_keys + mlp_keys
    dist_type = cfg.get("distribution", {}).get("type", "auto")
    gamma = float(cfg.algo.gamma)
    max_recompiles = cfg.algo.get("max_recompiles")

    # ---------------- learner: agent + train phase --------------------------
    state: Dict[str, Any] = {}
    if cfg.checkpoint.get("resume_from"):
        state = load_resume_state(cfg.checkpoint.resume_from, cfg)
    restore_generators(state, generators)
    agent = build_agent(fabric, actions_dim, is_continuous, cfg, obs_space, state.get("agent"))
    optimizer = build_optimizer(agent.named_parameters(), cfg.algo.optimizer, cfg.algo.max_grad_norm)
    if state.get("opt_state") is not None:
        optimizer.load_state_dict(state["opt_state"])
    trainer = PPOTrainer(cfg, agent, optimizer, obs_keys, actions_dim, is_continuous, rollout_steps, num_envs)
    learner_phase = fabric.compile(make_learner_phase(trainer, obs_keys), name=f"{cfg.algo.name}.sebulba_learner_phase",
                                   max_recompiles=max_recompiles,
                                   eager_reason="the annealed learning rate and coefficients are Python values")

    # ---------------- broadcast + queues -------------------------------------
    queue_timeout = float(topo_cfg.get("queue_timeout_s", 300.0))
    broadcast = ParamBroadcast(fabric, topo.actor_devices, max_staleness=int(topo_cfg.get("max_staleness", 2)),
                               gate_timeout_s=queue_timeout)
    sync_every = max(1, int(topo_cfg.get("sync_every", 1)))
    traj_queue = TrajQueue(clamp_queue_slots(topo_cfg, num_workers), rollout_steps, fabric, stage=True,
                           bootstrap_keys=tuple(f"last_{k}" for k in obs_keys), timeout_s=queue_timeout)
    stats_sink = StatsSink()
    stop_event = threading.Event()
    guard = WindowGuard(bool(cfg.buffer.get("transfer_guard", False)))

    # ---------------- actors: each with its own copy of the agent ------------
    # every actor graph is built here, before any thread starts
    engines: List[Any] = []
    supervisor: Optional[WorkerSupervisor] = None
    obs_queue: Optional[ObsQueue] = None

    def actor_copy() -> torch.nn.Module:
        return copy.deepcopy(agent).requires_grad_(False)

    def sample(out: torch.Tensor, noise: Any):
        return sample_actions(out, actions_dim, is_continuous, noise, dist_type=dist_type)

    if device_envs:
        for i, (dev, venv) in enumerate(zip(topo.actor_devices, venvs)):
            modules = actor_copy()
            player_gen = torch.Generator(dev).manual_seed(int(cfg.seed) + ACTOR_SEED + i)
            rollout = compile_rollout(
                fabric, make_rollout_fn(venv, modules, sample, cnn_keys=cnn_keys, mlp_keys=mlp_keys,
                                        action_space=act_space, gamma=gamma, rollout_steps=rollout_steps),
                player_gen, venv.generator, name=f"sebulba.fused_rollout[{i}]", max_recompiles=max_recompiles)

            def roll(carry: Dict[str, Any], _rollout=rollout, _gen=player_gen):
                return _rollout(carry, _gen)

            roll.compiled = rollout.compiled
            actor = FusedActor(i, dev, roll, init_actor_state(venv, 0), broadcast, traj_queue, modules=modules,
                               generators=(player_gen, venv.generator), stop_event=stop_event,
                               stats_sink=stats_sink, env_steps_per_segment=rollout_steps * venv.num_envs,
                               guard=guard)
            actor.warmup()
            engines.append(actor)
    else:
        envs_per_worker = num_envs // num_workers
        protocol = PPOWorkerProtocol(obs_keys, cnn_keys, mlp_keys, act_space, gamma)
        obs_queue = ObsQueue(max_pending=2 * num_workers)
        ladder = derive_ladder(envs_per_worker, num_workers, topo_cfg.get("actor_batch_ladder"))
        probe_prep = protocol.prepare({k: np.zeros((1, *obs_space[k].shape), obs_space[k].dtype) for k in obs_keys})
        obs_spec = {k: tuple(v.shape[1:]) for k, v in probe_prep.items()}
        for i, dev in enumerate(topo.actor_devices):
            modules = actor_copy()
            eng = ActorEngine(i, dev, make_policy(modules, actions_dim, is_continuous, dist_type), modules, obs_spec,
                              ladder, envs_per_worker, obs_queue, broadcast,
                              torch.Generator(dev).manual_seed(int(cfg.seed) + ACTOR_SEED + i),
                              max_wait_s=float(topo_cfg.get("max_wait_ms", 20.0)) / 1e3,
                              max_recompiles=max_recompiles)
            eng.warmup()
            engines.append(eng)
        supervisor = build_worker_fleet(
            cfg, topo_cfg, protocol=protocol, obs_queue=obs_queue, traj_queue=traj_queue,
            segment_steps=rollout_steps, num_workers=num_workers, envs_per_worker=envs_per_worker,
            log_dir=log_dir, stop_event=stop_event, stats_sink=stats_sink,
        )

    # ---------------- counters -----------------------------------------------
    aggregator = MetricAggregator(cfg.metric.aggregator.metrics if cfg.metric.log_level > 0 else {})
    timer.configure(cfg.metric)
    policy_steps_per_iter = num_envs * rollout_steps
    total_iters = 1 if cfg.dry_run else max(int(cfg.algo.total_steps) // policy_steps_per_iter, 1)
    start_iter = int(state.get("update", 0)) + 1 if state else 1
    policy_step = int(state.get("policy_step", 0))
    last_log = int(state.get("last_log", 0))
    last_checkpoint = int(state.get("last_checkpoint", 0))
    clip_coef, ent_coef = float(cfg.algo.clip_coef), float(cfg.algo.ent_coef)
    base_lr = float(cfg.algo.optimizer.lr)

    staleness_sum = staleness_max = segments_consumed = env_steps_consumed = updates_done = 0
    last_losses = None
    t_start = time.perf_counter()

    # queue and broadcast counters are live hub sources for the run; a fresh
    # span window makes the end-of-run breakdown cover the training loop
    HUB.register("sebulba.traj_queue", traj_queue.metrics)
    HUB.register("sebulba.broadcast", broadcast.metrics)
    SPANS.roll_window()
    arm_preemption(cfg)
    update = start_iter - 1

    def save_checkpoint() -> None:
        # the cadence save and the preemption save write the same state
        with guard.host():
            ckpt_mgr.save(policy_step, {
                "agent": agent.state_dict(),
                "opt_state": optimizer.state_dict(),
                "generators": {name: gen.get_state() for name, gen in generators.items()},
                "update": update,
                "policy_step": policy_step,
                "last_log": last_log,
                "last_checkpoint": last_checkpoint,
            })

    try:
        # inside the try: the first publish crosses a fault site, and a throw
        # there must still unregister the hub sources
        broadcast.publish(agent, version=start_iter - 1)
        for eng in engines:
            eng.start()
        if supervisor is not None:
            supervisor.start()
        for update in range(start_iter, total_iters + 1):
            with timer("Time/env_interaction_time"):
                items = drain_preemptible(traj_queue, num_workers, engines, supervisor, ckpt_mgr=ckpt_mgr,
                                          policy_step=policy_step, save_checkpoint=save_checkpoint)
            if items is None:  # preempted mid-wait: committed save done
                break
            publish = update % sync_every == 0 or update == total_iters
            with guard.host():
                segs = tuple(seg for seg, _ in items)
                for _, meta in items:
                    lag = broadcast.version - int(meta.get("version", 0))
                    staleness_sum += lag
                    staleness_max = max(staleness_max, lag)
                    env_steps_consumed += int(meta.get("env_steps", 0))
                segments_consumed += len(items)
                policy_step += policy_steps_per_iter
                updates_done += 1
                with timer("Time/train_time"):
                    last_losses = learner_phase(segs, train_gen, stage_scalar(clip_coef, device),
                                                stage_scalar(ent_coef, device))
                del segs, items
                if publish:
                    broadcast.publish(agent, version=update)
            if publish:
                broadcast.gate()
            if supervisor is not None:
                supervisor.check()

            with guard.host():
                # schedules (host-side, like the pipelined decoupled loop)
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
                    for ep_ret, ep_len in stats_sink.drain():
                        aggregator.update("Rewards/rew_avg", float(ep_ret))
                        aggregator.update("Game/ep_len_avg", int(ep_len))
                    if last_losses is not None:
                        for name, value in zip(("Loss/policy_loss", "Loss/value_loss", "Loss/entropy_loss"),
                                               last_losses):
                            aggregator.update(name, float(value))
                    extra = {**traj_queue.metrics(), **broadcast.metrics(),
                             "Sebulba/traj_staleness_max": float(staleness_max),
                             "Sebulba/traj_staleness_avg": staleness_sum / max(segments_consumed, 1),
                             "Sebulba/actor_idle_frac": float(np.mean([e.actor_idle_frac() for e in engines]))}
                    last_log = flush_metrics(aggregator, timer, logger, policy_step, last_log, extra_metrics=extra)

            if ckpt_mgr.should_save(policy_step, last_checkpoint, final=update == total_iters):
                last_checkpoint = policy_step
                save_checkpoint()
            if ckpt_mgr.preempted:
                print(f"Preemption: committed checkpoint at step {policy_step}, exiting", flush=True)
                break
    finally:
        # unregister on every exit: a leaked source would report a dead run's gauges
        HUB.unregister("sebulba.traj_queue")
        HUB.unregister("sebulba.broadcast")
        shutdown(stop_event, traj_queue, obs_queue, engines, supervisor)

    run_stats = collect_run_stats(
        topo=topo, updates=updates_done, wall_s=time.perf_counter() - t_start, env_steps=env_steps_consumed,
        engines=engines, traj_queue=traj_queue, broadcast=broadcast, traj_staleness_max=staleness_max,
        traj_staleness_sum=staleness_sum, segments_consumed=segments_consumed, supervisor=supervisor,
    )
    ckpt_mgr.finalize()
    if cfg.algo.run_test and not ckpt_mgr.preempted:
        test(agent, cfg, log_dir, logger)
    if logger is not None:
        logger.close()
    return run_stats
