"""Shared Sebulba runtime scaffolding (counterpart of
``sheeprl_tpu/sebulba/runner.py``; one copy for ``ppo.py`` and ``sac.py``):
queue sizing, the env-worker fleet, the learner's segment drain, the
preemption exit, teardown and the run-stats dict."""

from __future__ import annotations

import threading
import time
import warnings
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from sheeprl_tpu_torch.sebulba.actor import EnvWorker, WorkerSupervisor
from sheeprl_tpu_torch.sebulba.queues import ObsQueue, ServiceStopped, TrajQueue
from sheeprl_tpu_torch.telemetry.spans import SPANS, span
from sheeprl_tpu_torch.utils.env import make_env, vectorize


class DrainPreempted(Exception):
    """The SIGTERM/SIGINT latch fired while the learner was blocked on the
    trajectory queue: the runtimes run a final synchronous committed save and
    exit, instead of sitting out the queue timeout."""


class StatsSink:
    """Thread-safe, bounded episode-stats funnel: workers push, the learner
    drains at log time; the newest ``maxlen`` completions are kept."""

    def __init__(self, maxlen: int = 65536) -> None:
        self._lock = threading.Lock()
        self._items: Any = deque(maxlen=maxlen)

    def __call__(self, items) -> None:
        with self._lock:
            self._items.extend(items)

    def drain(self) -> List[Tuple[float, int]]:
        with self._lock:
            out = list(self._items)
            self._items.clear()
            return out


def clamp_queue_slots(topo_cfg: Dict[str, Any], n_producers: int) -> int:
    """The trajectory ring holds at least one segment per producer: the
    learner pops ``n_producers`` per update, so a smaller ring could never
    satisfy it."""
    slots = int(topo_cfg.get("traj_queue_slots", 4))
    if slots < n_producers:
        warnings.warn(
            f"topology.traj_queue_slots={slots} < {n_producers} producers: "
            "raising the ring to one segment per producer",
            RuntimeWarning,
        )
        slots = n_producers
    return slots


def build_worker_fleet(
    cfg: Any,
    topo_cfg: Dict[str, Any],
    *,
    protocol: Any,
    obs_queue: ObsQueue,
    traj_queue: TrajQueue,
    segment_steps: int,
    num_workers: int,
    envs_per_worker: int,
    log_dir: str,
    stop_event: threading.Event,
    stats_sink: Callable,
) -> WorkerSupervisor:
    """The env-worker fleet: worker ``i`` owns env slice ``[i*envs_per_worker,
    (i+1)*envs_per_worker)`` built through ``make_env``/``vectorize``; a
    respawn (bumped generation) reseeds the slice."""

    def spawn(worker_id: int, generation: int) -> EnvWorker:
        base = worker_id * envs_per_worker
        seed = cfg.seed + base + 100003 * generation

        def make_envs(_seed=seed, _base=base):
            return vectorize(cfg, [make_env(cfg, _seed + j, 0, run_name=log_dir, vector_env_idx=_base + j)
                                   for j in range(envs_per_worker)])

        return EnvWorker(
            worker_id, make_envs, protocol, obs_queue, traj_queue, segment_steps, seed,
            timeout_s=float(topo_cfg.get("queue_timeout_s", 300.0)),
            stop_event=stop_event, stats_sink=stats_sink, generation=generation,
        )

    return WorkerSupervisor(
        spawn, num_workers,
        deadline_s=float(topo_cfg.get("worker_deadline_s", 120.0)),
        max_restarts=int(topo_cfg.get("max_worker_restarts", 3)),
    )


def drain_segments(
    traj_queue: TrajQueue,
    n: int,
    engines: List[Any],
    supervisor: Optional[WorkerSupervisor],
    preempted: Optional[Callable[[], bool]] = None,
) -> List[Tuple[Dict[str, Any], Dict[str, Any]]]:
    """Pop ``n`` segments for one learner update, surfacing actor failures and
    driving worker respawns while waiting, within the queue's ``timeout_s``;
    a latched preemption raises :class:`DrainPreempted` within one short
    wait.  The wait is the learner's ``queue.wait`` span.  A wait slice is
    5 s, as in JAX, or half the supervisor's ``deadline_s`` when that is
    shorter, so a worker hung past its deadline is deposed while the learner
    waits for its segment."""
    deadline = time.monotonic() + traj_queue.timeout_s
    poll_s = 5.0 if supervisor is None else min(5.0, max(0.05, supervisor.deadline_s / 2))
    with span("queue.wait"):
        while True:
            if preempted is not None and preempted():
                raise DrainPreempted()
            try:
                return traj_queue.get_many(n, timeout_s=poll_s)
            except TimeoutError:
                for eng in engines:
                    if eng.error is not None:
                        raise eng.error
                if supervisor is not None:
                    supervisor.check()
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"trajectory queue produced < {n} segments in "
                        f"{traj_queue.timeout_s}s — actors wedged?"
                    )


def arm_preemption(cfg: Any) -> None:
    """Install the SIGTERM/SIGINT latch before the fleet starts, so a signal
    during the first queue wait is caught too."""
    from sheeprl_tpu_torch.checkpoint.preemption import PREEMPTION_GUARD

    if cfg.checkpoint.get("save_on_preemption", True):
        PREEMPTION_GUARD.install()


def drain_preemptible(
    traj_queue: TrajQueue,
    n: int,
    engines: List[Any],
    supervisor: Optional[WorkerSupervisor],
    *,
    ckpt_mgr: Any,
    policy_step: int,
    save_checkpoint: Callable[[], None],
) -> Optional[List[Tuple[Dict[str, Any], Dict[str, Any]]]]:
    """:func:`drain_segments` with the preemption exit: a latch fired
    mid-wait runs the runtime's final synchronous committed save and returns
    None (the caller leaves its loop; the teardown deposes the workers)."""
    try:
        return drain_segments(traj_queue, n, engines, supervisor, preempted=lambda: ckpt_mgr.preempted)
    except DrainPreempted:
        print(f"Preemption latched mid-drain: final committed save at step {policy_step}, exiting", flush=True)
        save_checkpoint()
        return None


def shutdown(
    stop_event: threading.Event,
    traj_queue: TrajQueue,
    obs_queue: Optional[ObsQueue],
    engines: List[Any],
    supervisor: Optional[WorkerSupervisor],
    join_timeout_s: float = 10.0,
) -> None:
    """Teardown in dependency order: stop flags, queues closed (pending
    inference requests failed so blocked workers unblock), engines stopped,
    workers deposed and joined, engines joined."""
    stop_event.set()
    traj_queue.close()
    if obs_queue is not None:
        for req in obs_queue.close():
            req.fail(ServiceStopped("sebulba run finished"))
    for eng in engines:
        if hasattr(eng, "stop"):
            eng.stop()
    if supervisor is not None:
        supervisor.stop()
    for eng in engines:
        eng.join(join_timeout_s)


def collect_run_stats(
    *,
    topo: Any,
    updates: int,
    wall_s: float,
    env_steps: int,
    engines: List[Any],
    traj_queue: TrajQueue,
    broadcast: Any,
    traj_staleness_max: int,
    traj_staleness_sum: int,
    segments_consumed: int,
    supervisor: Optional[WorkerSupervisor],
) -> Dict[str, Any]:
    """The run's stats (JAX's keys), assembled once."""
    return {
        "phase_breakdown": SPANS.breakdown(),
        "topology": topo.describe(),
        "updates": int(updates),
        "wall_s": wall_s,
        "env_steps": int(env_steps),
        "env_steps_per_s": env_steps / max(wall_s, 1e-9),
        "updates_per_s": updates / max(wall_s, 1e-9),
        "actor_idle_frac": float(np.mean([eng.actor_idle_frac() for eng in engines])),
        "queue_depth_frac": float(traj_queue.metrics()["Sebulba/queue_depth_frac"]),
        "param_staleness_max": int(broadcast.staleness_max),
        "traj_staleness_max": int(traj_staleness_max),
        "traj_staleness_avg": traj_staleness_sum / max(segments_consumed, 1),
        "actor_cache_sizes": [eng.cache_sizes() for eng in engines],
        "worker_restarts": supervisor.restarts if supervisor is not None else 0,
        "torn_rejected": traj_queue.torn_rejected,
    }
