"""Sebulba SAC (counterpart of ``sheeprl_tpu/sebulba/sac.py``): decoupled SAC
on the actor/learner split (``topology=sebulba``), both roles on the one
device.

The skeleton of :mod:`sheeprl_tpu_torch.sebulba.ppo`, with the off-policy
differences:

* env workers push fixed-length **transition segments**
  (``topology.segment_steps`` × per-worker envs of ``obs/next_obs/actions/
  rewards/terminated`` rows); the queue stays on the host (``stage=False``)
  because the learner's store is the replay ring itself
  (:class:`~sheeprl_tpu_torch.data.device_replay.DeviceReplay` on the card
  with ``buffer.device``), which the learner appends the consumed segments
  into;
* the learner runs the ``Ratio``-owed updates of each round through
  ``fused_uniform_train`` (drawn and gathered on the card), in power-of-two
  chunks, eagerly under the compile-once audit as SAC's own loop does;
* only the actor's modules are broadcast (the critics never leave the
  learner).

Workers take uniform random actions (numpy's draws from the worker's seed)
until their share of ``algo.learning_starts`` env steps is collected.
"""

from __future__ import annotations

import copy
import os
import threading
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.sac.agent import build_agent, sample_action
from sheeprl_tpu_torch.algos.sac.sac import SACTrainer, VectorLayout, test_actor
from sheeprl_tpu_torch.algos.sac.utils import prepare_obs, test
from sheeprl_tpu_torch.convert import load_resume_state, restore_generators
from sheeprl_tpu_torch.data.buffers import ReplayBuffer
from sheeprl_tpu_torch.data.device_replay import (
    build_device_replay,
    estimate_step_bytes,
    fused_uniform_train,
    resolve_device_replay,
    update_chunks,
)
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.parallel.topology import DeviceTopology, ParamBroadcast, topology_cfg
from sheeprl_tpu_torch.sebulba.actor import ActorEngine, EnvWorker, derive_ladder
from sheeprl_tpu_torch.sebulba.ppo import ACTOR_SEED
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
from sheeprl_tpu_torch.utils.timer import timer
from sheeprl_tpu_torch.utils.utils import Ratio, save_configs

TRANSITION_KEYS = ("obs", "next_obs", "actions", "rewards", "terminated")


class SACWorkerProtocol:
    """Per-step semantics of a SAC env worker: flattened-vector blocks out,
    tanh-squashed actions back; uniform random prefill until this worker's
    share of ``learning_starts`` is collected; ``next_obs`` rows carry the
    true final observation on done envs (autoreset replaced it)."""

    def __init__(self, mlp_keys, act_space: spaces.Box, prefill_steps: int):
        self.mlp_keys = tuple(mlp_keys)
        self.act_low = np.asarray(act_space.low, np.float32)
        self.act_high = np.asarray(act_space.high, np.float32)
        self.act_shape = act_space.shape
        self.prefill_steps = int(prefill_steps)

    def to_env_actions(self, a: np.ndarray) -> np.ndarray:
        return self.act_low + (a + 1.0) * 0.5 * (self.act_high - self.act_low)

    def _random_actions(self, rng: np.random.Generator, n: int) -> np.ndarray:
        env_actions = rng.uniform(self.act_low, self.act_high, (n,) + self.act_shape)
        span = self.act_high - self.act_low
        return np.clip(
            2.0 * (env_actions - self.act_low) / np.where(span == 0, 1, span) - 1.0, -1, 1
        ).astype(np.float32).reshape(n, -1)

    def on_reset(self, worker: EnvWorker, obs) -> None:
        worker._rng = np.random.default_rng(worker.seed)

    def run_segment(self, worker: EnvWorker, envs: Any, obs: Dict[str, np.ndarray], steps: int
                    ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray], List[Tuple[float, int]], int]:
        num_envs = envs.num_envs
        rows: Dict[str, List[np.ndarray]] = {k: [] for k in TRANSITION_KEYS}
        ep_stats: List[Tuple[float, int]] = []
        obs_vec = prepare_obs(obs, self.mlp_keys)
        for _ in range(steps):
            worker.beat()
            if worker.env_steps + len(rows["obs"]) * num_envs < self.prefill_steps:
                actions = self._random_actions(worker._rng, num_envs)
            else:
                actions = np.asarray(worker.infer({"obs": obs_vec})["actions"]).reshape(num_envs, -1)
            next_obs, rewards, terminated, truncated, info = envs.step(self.to_env_actions(actions))
            dones = np.logical_or(terminated, truncated)
            rewards = np.asarray(rewards, np.float32)
            next_vec = prepare_obs(next_obs, self.mlp_keys)
            store_next = next_vec
            done_idx = np.nonzero(dones)[0]
            if done_idx.size:
                final = final_obs_rows(info, done_idx, self.mlp_keys)
                if final is not None:
                    store_next = next_vec.copy()
                    store_next[done_idx] = np.concatenate(
                        [np.asarray(final[k], np.float32).reshape(done_idx.size, -1) for k in self.mlp_keys],
                        axis=-1)
            rows["obs"].append(obs_vec)
            rows["next_obs"].append(store_next)
            rows["actions"].append(actions.astype(np.float32))
            rows["rewards"].append(rewards.reshape(num_envs, 1))
            rows["terminated"].append(np.asarray(terminated, np.float32).reshape(num_envs, 1))
            obs_vec = next_vec
            obs = next_obs
            ep_stats.extend(episode_stats(info))
        segment = {k: np.stack(v, axis=0) for k, v in rows.items()}
        return obs, segment, ep_stats, steps * num_envs


def run_sebulba(fabric: Any, cfg: Any) -> Dict[str, Any]:
    """Train decoupled SAC through the Sebulba topology; returns the run's
    stats (throughput, queue and staleness counters)."""
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
    segment_steps = max(1, int(topo_cfg.get("segment_steps", 16)))
    num_workers = max(1, int(topo_cfg.get("env_workers", 2)))
    if num_envs % num_workers:
        raise ValueError(f"sebulba env workers need env.num_envs ({num_envs}) divisible "
                         f"by topology.env_workers ({num_workers})")
    envs_per_worker = num_envs // num_workers

    probe = make_env(cfg, cfg.seed, 0, run_name=log_dir, vector_env_idx=0)()
    obs_space, act_space = probe.observation_space, probe.action_space
    probe.close()
    if not isinstance(act_space, spaces.Box):
        raise ValueError("SAC supports continuous (Box) action spaces only, like the reference")
    layout = VectorLayout(cfg, obs_space)
    act_dim = int(np.prod(act_space.shape))
    max_recompiles = cfg.algo.get("max_recompiles")

    # ---------------- learner: agent + train window --------------------------
    state: Dict[str, Any] = {}
    if cfg.checkpoint.get("resume_from"):
        state = load_resume_state(cfg.checkpoint.resume_from, cfg)
    restore_generators(state, generators)
    agent = build_agent(fabric, act_dim, cfg, layout.agent_input, state.get("agent"))
    trainer = SACTrainer(cfg, agent, SACTrainer.build_optimizers(cfg, agent, state.get("opt_state")), act_dim)

    # ---------------- the replay ring on the learner's device ----------------
    capacity = int(cfg.buffer.size) // num_envs
    memmap_dir = os.path.join(log_dir, "memmap_buffer", "rank_0") if cfg.buffer.memmap else None
    use_device_replay = resolve_device_replay(cfg, device)
    if use_device_replay:
        rb: Any = build_device_replay(
            cfg, capacity, num_envs, device,
            estimate_step_bytes(obs_space, layout.obs_keys, extra_bytes=4 * (act_dim + 2), copies_per_key=2),
            sequential=False, memmap_dir=memmap_dir)
    else:
        rb = ReplayBuffer(capacity, num_envs, memmap=cfg.buffer.memmap, memmap_dir=memmap_dir)
    if state.get("rb") is not None and cfg.buffer.checkpoint:
        from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import _rb_state_from_checkpoint

        rb.load_state_dict(_rb_state_from_checkpoint(state["rb"]))
    batch_size = int(cfg.algo.per_rank_batch_size)
    eager = "the off-policy update is captured later (ROADMAP.md, queue A item 3(e))"
    if use_device_replay:
        def window_fn(n, counter):
            return fused_uniform_train(trainer, rb, train_gen, batch_size, n, layout.prep, counter)
    else:
        def window_fn(batches, counter):
            return counter + batches["rewards"].shape[0], trainer.train_phase(batches, train_gen, counter)
    train_window = fabric.compile(
        window_fn, name=f"{cfg.algo.name}.sebulba_train_phase" + ("_device" if use_device_replay else ""),
        static_argnums=(0,) if use_device_replay else (), max_recompiles=max_recompiles, eager_reason=eager)

    # ---------------- broadcast + queues + actors ----------------------------
    queue_timeout = float(topo_cfg.get("queue_timeout_s", 300.0))
    broadcast = ParamBroadcast(fabric, topo.actor_devices, extract=lambda a: a.actor,
                               max_staleness=int(topo_cfg.get("max_staleness", 2)), gate_timeout_s=queue_timeout)
    sync_every = max(1, int(topo_cfg.get("sync_every", 1)))
    traj_queue = TrajQueue(clamp_queue_slots(topo_cfg, num_workers), segment_steps, fabric, stage=False,
                           timeout_s=queue_timeout)
    stats_sink = StatsSink()
    stop_event = threading.Event()
    obs_queue = ObsQueue(max_pending=2 * num_workers)
    ladder = derive_ladder(envs_per_worker, num_workers, topo_cfg.get("actor_batch_ladder"))
    engines: List[ActorEngine] = []
    for i, dev in enumerate(topo.actor_devices):
        actor = copy.deepcopy(agent.actor).requires_grad_(False)

        def policy(obs: Dict[str, torch.Tensor], noise: Any, _actor=actor) -> Dict[str, torch.Tensor]:
            return {"actions": sample_action(_actor, obs["obs"], noise)[0]}

        eng = ActorEngine(i, dev, policy, actor, {"obs": (layout.agent_input,)}, ladder, envs_per_worker, obs_queue,
                          broadcast, torch.Generator(dev).manual_seed(int(cfg.seed) + ACTOR_SEED + i),
                          max_wait_s=float(topo_cfg.get("max_wait_ms", 20.0)) / 1e3, max_recompiles=max_recompiles)
        eng.warmup()
        engines.append(eng)

    learning_starts = int(cfg.algo.learning_starts) if not cfg.dry_run else 0
    protocol = SACWorkerProtocol(layout.mlp_keys, act_space, prefill_steps=-(-learning_starts // num_workers))
    supervisor = build_worker_fleet(
        cfg, topo_cfg, protocol=protocol, obs_queue=obs_queue, traj_queue=traj_queue, segment_steps=segment_steps,
        num_workers=num_workers, envs_per_worker=envs_per_worker, log_dir=log_dir, stop_event=stop_event,
        stats_sink=stats_sink,
    )

    # ---------------- counters -----------------------------------------------
    aggregator = MetricAggregator(cfg.metric.aggregator.metrics if cfg.metric.log_level > 0 else {})
    timer.configure(cfg.metric)
    steps_per_round = num_envs * segment_steps
    total_rounds = 1 if cfg.dry_run else max(int(cfg.algo.total_steps) // steps_per_round, 1)
    start_round = int(state.get("update", 0)) + 1 if state else 1
    policy_step = int(state.get("policy_step", 0))
    last_log = int(state.get("last_log", 0))
    last_checkpoint = int(state.get("last_checkpoint", 0))
    grad_step_counter = int(state.get("grad_steps", 0))
    windows = int(state.get("windows", 0))
    ratio = Ratio(cfg.algo.replay_ratio, pretrain_steps=cfg.algo.per_rank_pretrain_steps)
    if "ratio" in state:
        ratio.load_state_dict(state["ratio"])

    staleness_sum = staleness_max = segments_consumed = env_steps_consumed = 0
    last_losses = None
    t_start = time.perf_counter()

    HUB.register("sebulba.traj_queue", traj_queue.metrics)
    HUB.register("sebulba.broadcast", broadcast.metrics)
    SPANS.roll_window()
    arm_preemption(cfg)
    rnd = start_round - 1

    def save_checkpoint() -> None:
        ckpt_state = {
            "agent": agent.state_dict(),
            "opt_state": trainer.opt_state(),
            "generators": {name: gen.get_state() for name, gen in generators.items()},
            "update": rnd,
            "policy_step": policy_step,
            "last_log": last_log,
            "last_checkpoint": last_checkpoint,
            "ratio": ratio.state_dict(),
            "grad_steps": grad_step_counter,
            "windows": windows,
        }
        if cfg.buffer.checkpoint:
            ckpt_state["rb"] = rb.state_dict()
        ckpt_mgr.save(policy_step, ckpt_state)

    try:
        # inside the try: the first publish crosses a fault site
        broadcast.publish(agent, version=windows)
        for eng in engines:
            eng.start()
        supervisor.start()
        for rnd in range(start_round, total_rounds + 1):
            with timer("Time/env_interaction_time"):
                items = drain_preemptible(traj_queue, num_workers, engines, supervisor, ckpt_mgr=ckpt_mgr,
                                          policy_step=policy_step, save_checkpoint=save_checkpoint)
            if items is None:  # preempted mid-wait: committed save done
                break
            for seg, meta in items:
                base = int(meta.get("worker", 0)) * envs_per_worker
                rb.add({k: np.asarray(v) for k, v in seg.items()}, indices=range(base, base + envs_per_worker))
                lag = broadcast.version - int(meta.get("version", 0))
                staleness_sum += lag
                staleness_max = max(staleness_max, lag)
                env_steps_consumed += int(meta.get("env_steps", 0))
            segments_consumed += len(items)
            policy_step += steps_per_round

            if policy_step >= learning_starts:
                gradient_steps = ratio(policy_step)
                if gradient_steps > 0:
                    windows += 1
                    with timer("Time/train_time"):
                        if use_device_replay:
                            for u in update_chunks(gradient_steps,
                                                   bytes_per_update=rb.sampled_bytes_per_update(batch_size)):
                                grad_step_counter, last_losses = train_window(u, grad_step_counter)
                        else:
                            batches = layout.batches(rb.sample(batch_size, n_samples=gradient_steps), device)
                            grad_step_counter, last_losses = train_window(batches, grad_step_counter)
                            del batches
                    if windows % sync_every == 0:
                        broadcast.publish(agent, version=windows)
                        broadcast.gate()
            supervisor.check()

            if cfg.metric.log_level > 0 and (
                policy_step - last_log >= cfg.metric.log_every or rnd == total_rounds or cfg.dry_run
            ):
                for ep_ret, ep_len in stats_sink.drain():
                    aggregator.update("Rewards/rew_avg", float(ep_ret))
                    aggregator.update("Game/ep_len_avg", int(ep_len))
                if last_losses is not None:
                    for name, value in zip(SACTrainer.LOSS_NAMES, last_losses):
                        aggregator.update(name, float(value))
                extra = {**traj_queue.metrics(), **broadcast.metrics(),
                         "Sebulba/traj_staleness_max": float(staleness_max),
                         "Sebulba/traj_staleness_avg": staleness_sum / max(segments_consumed, 1),
                         "Sebulba/actor_idle_frac": float(np.mean([e.actor_idle_frac() for e in engines])),
                         "Params/replay_ratio": grad_step_counter / max(policy_step, 1)}
                last_log = flush_metrics(aggregator, timer, logger, policy_step, last_log, extra_metrics=extra)

            if ckpt_mgr.should_save(policy_step, last_checkpoint, final=rnd == total_rounds):
                last_checkpoint = policy_step
                save_checkpoint()
            if ckpt_mgr.preempted:
                print(f"Preemption: committed checkpoint at step {policy_step}, exiting", flush=True)
                break
    finally:
        HUB.unregister("sebulba.traj_queue")
        HUB.unregister("sebulba.broadcast")
        shutdown(stop_event, traj_queue, obs_queue, engines, supervisor)

    run_stats = collect_run_stats(
        topo=topo, updates=windows, wall_s=time.perf_counter() - t_start, env_steps=env_steps_consumed,
        engines=engines, traj_queue=traj_queue, broadcast=broadcast, traj_staleness_max=staleness_max,
        traj_staleness_sum=staleness_sum, segments_consumed=segments_consumed, supervisor=supervisor,
    )
    if getattr(rb, "spill", None) is not None:
        rb.spill.close()
    ckpt_mgr.finalize()
    if cfg.algo.run_test and not ckpt_mgr.preempted:
        test(test_actor(SACTrainer, SACTrainer.player_modules(agent), layout, device, int(cfg.seed)), cfg, log_dir,
             logger)
    if logger is not None:
        logger.close()
    return run_stats
