"""Sebulba actor side (counterpart of ``sheeprl_tpu/sebulba/actor.py``):
batched inference engines and env-worker threads.

One :class:`ActorEngine` runs per actor device: a dispatcher thread
coalesces env workers' observation blocks off the shared
:class:`~sheeprl_tpu_torch.sebulba.queues.ObsQueue` (the serve batcher's
max-batch/max-wait policy), pads the batch up to a static **ladder** rung and
runs one compile-once program per rung (``fabric.compile``: one captured CUDA
graph per rung on the card), so every rung holds ``cache_size() == 1`` for
the run.  Every rung is built before traffic (:meth:`ActorEngine.warmup`, on
the thread that builds the run, before any thread starts): no graph is
captured while another thread launches work.  The engine acts with its own
copy of the policy's modules, which the graphs read; a new published version
is copied into them between two dispatches
(:meth:`~sheeprl_tpu_torch.parallel.topology.StagedCopy.copy_into`).  Its
draws come from its own ``torch.Generator`` on the device, registered with
every rung's graph; the warm-up's draws are put back, so the first dispatch
draws what it would have drawn without a warm-up.  On the card the engine
runs on a CUDA stream of its own.

Env workers are threads that drive host envs: each owns ``num_envs /
env_workers`` envs through ``utils.env.vectorize`` (worker processes under
``env.sync_env=False``), submits its observation block per step and
assembles fixed-length segments that it pushes into the
:class:`~sheeprl_tpu_torch.sebulba.queues.TrajQueue`.  Workers heartbeat; a
crashed or hung worker (the ``sebulba.env_worker`` fault site) is **deposed
and respawned** by :class:`WorkerSupervisor`, and a deposed worker never
pushes again, so partial segments die with it.

For device envs :class:`FusedActor` runs the Anakin rollout
(``envs/device/anakin.py::compile_rollout``: one captured graph of the whole
rollout on the card) and queues each finished segment.  A graph's outputs
are its own buffers, rewritten by the next replay, so the segment is copied
off them before it is queued.  ``buffer.transfer_guard`` arms
``steady_guard`` around the actor's windows after the first; the sync debug
mode it sets is process-wide, so :class:`WindowGuard` makes an armed window
and the learner's work outside its waits exclude each other.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.data.device_replay import stage, steady_guard
from sheeprl_tpu_torch.parallel.compile import GraphFunction, compile_once
from sheeprl_tpu_torch.parallel.topology import ParamBroadcast, StagedCopy, named_tensors
from sheeprl_tpu_torch.resilience.faults import fault_point
from sheeprl_tpu_torch.sebulba.queues import ObsBlock, ObsQueue, ServiceStopped, TrajQueue
from sheeprl_tpu_torch.serve.batcher import pick_ladder_size


def derive_ladder(block_rows: int, max_blocks: int, override: Optional[Sequence[int]] = None) -> Tuple[int, ...]:
    """The static batch ladder for actor inference: multiples of the
    per-worker block size in powers of two, topped by the full round
    (``block_rows * max_blocks``) so a fully-coalesced step pads nothing."""
    if override:
        ladder = sorted({int(b) for b in override})
        if any(b % block_rows for b in ladder):
            raise ValueError(
                f"topology.actor_batch_ladder {ladder} must be multiples of "
                f"the worker block size ({block_rows} rows)"
            )
        return tuple(ladder)
    sizes = set()
    b = block_rows
    while b < block_rows * max_blocks:
        sizes.add(b)
        b *= 2
    sizes.add(block_rows * max_blocks)
    return tuple(sorted(sizes))


def actor_stream(device: torch.device) -> Any:
    """A CUDA stream of the actor's own on the card (None on the CPU)."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def on_stream(stream: Any) -> Any:
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


class WindowGuard:
    """``buffer.transfer_guard`` for threads that share one process.

    ``steady_guard`` sets the sync debug mode of the whole process, so a
    learner that reads a value back while an actor's window is armed would
    raise.  An armed window (:meth:`window`) and the learner's work outside
    its queue and gate waits (:meth:`host`) take one lock; disabled, both are
    no-ops."""

    def __init__(self, enabled: bool):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def window(self, armed: bool) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        with self._lock, steady_guard(armed):
            yield

    @contextlib.contextmanager
    def host(self) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        with self._lock:
            yield


class ActorEngine(threading.Thread):
    """One actor device's batched-inference dispatcher.

    ``policy(obs, generator) -> outputs`` is the algorithm's per-row policy
    (outputs: dict of ``(rows, ...)`` tensors) on ``modules``, the engine's
    own copy of what the broadcast publishes; ``obs_spec`` gives each
    observation key's per-row shape (float32, as the workers prepare it).
    Each ladder rung gets its own compile-once program
    (``sebulba.actor_step[i]@rung``), built by :meth:`warmup` ahead of
    traffic."""

    def __init__(
        self,
        index: int,
        device: Any,
        policy: Callable[[Dict[str, torch.Tensor], torch.Generator], Dict[str, torch.Tensor]],
        modules: Any,
        obs_spec: Dict[str, Tuple[int, ...]],
        ladder: Sequence[int],
        block_rows: int,
        obs_queue: ObsQueue,
        broadcast: ParamBroadcast,
        generator: torch.Generator,
        *,
        max_wait_s: float = 0.02,
        max_recompiles: Optional[int] = None,
        name: str = "sebulba.actor",
    ):
        super().__init__(name=f"{name}[{index}]", daemon=True)
        self.index = int(index)
        self.device = torch.device(device)
        self.ladder = tuple(sorted(int(b) for b in ladder))
        self.block_rows = int(block_rows)
        self.obs_queue = obs_queue
        self.broadcast = broadcast
        self.max_wait_s = float(max_wait_s)
        self.generator = generator
        self._obs_spec = dict(obs_spec)
        self._live = named_tensors(modules)
        self._installed: Optional[StagedCopy] = None
        self.stream = actor_stream(self.device)
        self._stop_event = threading.Event()
        self.error: Optional[BaseException] = None
        # observability
        self.dispatches = 0
        self.rows_served = 0
        self.rows_padded = 0
        self.idle_s = 0.0
        self.busy_s = 0.0

        def step(obs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            return policy(obs, generator)

        # one compile-once program PER LADDER RUNG: each sees exactly one
        # signature, so cache_size() == 1 is the per-rung steady-state law
        self.executables: Dict[int, GraphFunction] = {
            rung: compile_once(step, name=f"sebulba.actor_step[{index}]@{rung}", max_recompiles=max_recompiles,
                               device=self.device, generators=(generator,))
            for rung in self.ladder
        }

    # -- warm-up --------------------------------------------------------------
    def _zeros(self, rung: int) -> Dict[str, torch.Tensor]:
        return {k: torch.zeros((rung, *shape), device=self.device) for k, shape in self._obs_spec.items()}

    def warmup(self) -> None:
        """Build every rung (on the card: run it once and capture its graph)
        before traffic; the generator's state is put back after."""
        state = self.generator.get_state()
        with on_stream(self.stream), torch.no_grad():
            for rung in self.ladder:
                self.executables[rung](self._zeros(rung))
        if self.stream is not None:
            self.stream.synchronize()
        self.generator.set_state(state)

    def cache_sizes(self) -> Dict[int, int]:
        return {rung: fn.cache_size() for rung, fn in self.executables.items()}

    # -- dispatch loop --------------------------------------------------------
    def stop(self) -> None:
        self._stop_event.set()

    def actor_idle_frac(self) -> float:
        total = self.idle_s + self.busy_s
        return self.idle_s / total if total > 0 else 0.0

    def install(self) -> int:
        """Fetch the newest published version and, when it is new, copy it
        into the engine's tensors on the current stream; returns the version."""
        staged, version = self.broadcast.fetch(self.index)
        if staged is not None and staged is not self._installed:
            staged.copy_into(self._live)
            self._installed = staged
        return version

    def _dispatch(self, blocks: List[ObsBlock]) -> None:
        rows = sum(b.rows for b in blocks)
        rung = pick_ladder_size(rows, self.ladder)
        batch: Dict[str, np.ndarray] = {}
        for k, shape in self._obs_spec.items():
            buf = np.zeros((rung, *shape), np.float32)
            at = 0
            for b in blocks:
                buf[at:at + b.rows] = b.obs[k]
                at += b.rows
            batch[k] = buf
        with on_stream(self.stream), torch.no_grad():
            version = self.install()
            outputs = self.executables[rung]({k: stage(v, self.device) for k, v in batch.items()})
            outputs = {k: v.cpu().numpy() for k, v in outputs.items()}
        self.dispatches += 1
        self.rows_served += rows
        self.rows_padded += rung - rows
        at = 0
        for b in blocks:
            row_out: Dict[str, Any] = {k: v[at:at + b.rows] for k, v in outputs.items()}
            row_out["_version"] = version
            at += b.rows
            b.resolve(row_out)

    def run(self) -> None:
        max_blocks = max(self.ladder) // self.block_rows
        try:
            while not self._stop_event.is_set():
                t0 = time.perf_counter()
                blocks = self.obs_queue.get_batch(max_blocks, self.max_wait_s)
                self.idle_s += time.perf_counter() - t0
                blocks = [b for b in blocks if not b.cancelled]
                if not blocks:
                    if self.obs_queue.closed:
                        break
                    continue
                t1 = time.perf_counter()
                try:
                    self._dispatch(blocks)
                except BaseException as e:  # noqa: BLE001 — fail the callers, then re-raise
                    for b in blocks:
                        b.fail(e)
                    raise
                self.busy_s += time.perf_counter() - t1
        except BaseException as e:  # noqa: BLE001 — surfaced by the runner
            if not self._stop_event.is_set():
                self.error = e


class _Deposed(RuntimeError):
    """Raised inside a worker the supervisor gave up on (hang respawn)."""


class EnvWorker(threading.Thread):
    """One env-worker thread: steps its env slice, requests actions from the
    actor group, assembles fixed-length segments.

    ``protocol.run_segment(worker, envs, obs, steps) -> (next_obs, segment,
    episode_stats, env_steps)`` owns the algorithm's step semantics, with
    :meth:`infer` round-tripping one observation block through the actors.
    A worker whose :attr:`deposed` flag is set exits at the next boundary and
    never pushes a segment again."""

    def __init__(
        self,
        worker_id: int,
        make_envs: Callable[[], Any],
        protocol: Any,
        obs_queue: ObsQueue,
        traj_queue: TrajQueue,
        rollout_steps: int,
        seed: int,
        *,
        timeout_s: float = 300.0,
        stop_event: Optional[threading.Event] = None,
        stats_sink: Optional[Callable[[Sequence[Tuple[float, int]]], None]] = None,
        generation: int = 0,
    ):
        super().__init__(name=f"sebulba.env_worker[{worker_id}]g{generation}", daemon=True)
        self.worker_id = int(worker_id)
        self.make_envs = make_envs
        self.protocol = protocol
        self.obs_queue = obs_queue
        self.traj_queue = traj_queue
        self.rollout_steps = int(rollout_steps)
        self.seed = int(seed)
        self.timeout_s = float(timeout_s)
        self.stop_event = stop_event or threading.Event()
        self.stats_sink = stats_sink
        self.generation = int(generation)
        self.deposed = False
        self.error: Optional[BaseException] = None
        self.last_beat = time.monotonic()
        self.segments_pushed = 0
        self.env_steps = 0
        self._last_version = 0

    # -- actor round-trip -----------------------------------------------------
    def infer(self, block: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        rows = int(next(iter(block.values())).shape[0])
        req = ObsBlock(self.worker_id, block, rows)
        self.obs_queue.put(req, block=True, timeout=self.timeout_s)
        # wait in slices, touching the heartbeat: queueing behind a slow
        # actor dispatch is liveness, not a hang
        deadline = time.monotonic() + self.timeout_s
        while not req.event.wait(0.25):
            self.touch()
            if self.deposed:
                req.cancelled = True
                raise _Deposed()
            if time.monotonic() > deadline:
                req.cancelled = True
                raise TimeoutError("actor inference request timed out")
        if req.error is not None:
            raise req.error
        out = req.result
        self._last_version = int(out.get("_version", self._last_version))
        return out

    def touch(self) -> None:
        """Refresh the heartbeat without the fault site (from waits where the
        worker is blocked but healthy)."""
        self.last_beat = time.monotonic()

    def beat(self) -> None:
        self.last_beat = time.monotonic()
        # the sebulba.env_worker fault site fires per env step, from the
        # worker's own thread: `raise` kills the worker, `hang` wedges it
        fault_point("sebulba.env_worker")
        if self.deposed:
            raise _Deposed()

    def _push_abort(self) -> bool:
        """The generation fence ``TrajQueue.put`` evaluates under its lock."""
        self.touch()
        return self.deposed or self.stop_event.is_set()

    def run(self) -> None:
        envs = None
        try:
            envs = self.make_envs()
            obs, _ = envs.reset(seed=self.seed)
            self.protocol.on_reset(self, obs)
            while not self.stop_event.is_set() and not self.deposed:
                version_at_start = self._last_version
                obs, segment, ep_stats, steps = self.protocol.run_segment(self, envs, obs, self.rollout_steps)
                self.env_steps += steps
                if self.stats_sink and ep_stats:
                    self.stats_sink(ep_stats)
                if self.deposed or self.stop_event.is_set():
                    break  # partial/stale work dies with the worker
                self.traj_queue.put(
                    segment,
                    meta={"version": version_at_start, "worker": self.worker_id, "env_steps": steps,
                          "generation": self.generation},
                    abort=self._push_abort,
                )
                self.segments_pushed += 1
        except (_Deposed, ServiceStopped):
            pass
        except BaseException as e:  # noqa: BLE001 — surfaced to the supervisor
            if not self.stop_event.is_set():
                self.error = e
        finally:
            if envs is not None:
                try:
                    envs.close()
                except Exception:  # noqa: BLE001 — a dying worker's envs
                    pass


class WorkerSupervisor:
    """Respawn policy for the env-worker fleet: :meth:`check` (driven from
    the learner loop) deposes workers that died or stalled past
    ``deadline_s`` and respawns them with fresh envs and a bumped
    generation, up to ``max_restarts`` in all."""

    def __init__(self, spawn: Callable[[int, int], EnvWorker], num_workers: int, *, deadline_s: float = 120.0,
                 max_restarts: int = 3):
        self.spawn = spawn
        self.deadline_s = float(deadline_s)
        self.max_restarts = int(max_restarts)
        self.restarts = 0
        self.workers: List[EnvWorker] = [spawn(i, 0) for i in range(num_workers)]

    def start(self) -> None:
        for w in self.workers:
            w.start()

    def check(self) -> None:
        """Depose and respawn wedged or dead workers; raise when the restart
        budget is spent."""
        now = time.monotonic()
        for i, w in enumerate(self.workers):
            dead = not w.is_alive() and w.error is not None
            hung = w.is_alive() and (now - w.last_beat) > self.deadline_s
            if not (dead or hung):
                continue
            if self.restarts >= self.max_restarts:
                raise RuntimeError(
                    f"env worker {w.worker_id} {'died' if dead else 'hung'} "
                    f"with the restart budget exhausted ({self.max_restarts})"
                ) from w.error
            self.restarts += 1
            w.deposed = True  # a hung thread exits at its next beat
            logging.getLogger(__name__).warning(
                "sebulba: env worker %d %s (%s); respawning (restart %d/%d)",
                w.worker_id, "died" if dead else f"hung for {now - w.last_beat:.1f}s", w.error,
                self.restarts, self.max_restarts,
            )
            from sheeprl_tpu_torch.telemetry.monitors import RESILIENCE_MONITOR

            RESILIENCE_MONITOR.record_stall(f"sebulba.env_worker[{w.worker_id}]")
            fresh = self.spawn(w.worker_id, w.generation + 1)
            self.workers[i] = fresh
            fresh.start()

    def stop(self, join_timeout: float = 10.0) -> None:
        for w in self.workers:
            w.deposed = True
        for w in self.workers:
            w.join(join_timeout)

    def alive(self) -> int:
        return sum(1 for w in self.workers if w.is_alive())


class FusedActor(threading.Thread):
    """The Anakin rollout as an actor, for device envs.

    ``rollout(carry) -> (carry', segment, last_obs, stats)`` is the compiled
    rollout of :func:`~sheeprl_tpu_torch.envs.device.anakin.compile_rollout`
    acting with ``modules`` (the actor's own copy of the agent), drawing from
    ``generators`` (the player's and the envs').  :meth:`warmup` builds it on
    a copy of the carry before the threads start and puts the generators'
    states back.  Each window fetches the newest version, replays the
    rollout, and copies the segment and the last observations off the
    graph's buffers; the copy is queued with ``last_<key>`` bootstrap
    leaves."""

    def __init__(
        self,
        index: int,
        device: Any,
        rollout: Callable[[Dict[str, Any]], Tuple[Any, ...]],
        carry: Dict[str, Any],
        broadcast: ParamBroadcast,
        traj_queue: TrajQueue,
        *,
        modules: Any,
        generators: Sequence[torch.Generator] = (),
        stop_event: Optional[threading.Event] = None,
        stats_sink: Optional[Callable[[Sequence[Tuple[float, int]]], None]] = None,
        env_steps_per_segment: int = 0,
        guard: Optional[WindowGuard] = None,
    ):
        super().__init__(name=f"sebulba.fused_actor[{index}]", daemon=True)
        self.index = int(index)
        self.device = torch.device(device)
        self.rollout = rollout
        self._carry = carry
        self.broadcast = broadcast
        self.traj_queue = traj_queue
        self.generators = tuple(generators)
        self._live = named_tensors(modules)
        self._installed: Optional[StagedCopy] = None
        self.stream = actor_stream(self.device)
        self.stop_event = stop_event or threading.Event()
        self.stats_sink = stats_sink
        self.env_steps_per_segment = int(env_steps_per_segment)
        self.guard = guard or WindowGuard(False)
        self.error: Optional[BaseException] = None
        self.segments_pushed = 0
        self.env_steps = 0
        self.idle_s = 0.0
        self.busy_s = 0.0

    def warmup(self) -> None:
        """Build the rollout on a copy of the carry (on the card: run it once
        and capture its graph), then put the generators' states back."""
        states = [g.get_state() for g in self.generators]
        with on_stream(self.stream):
            self.rollout(copy.deepcopy(self._carry))
        if self.stream is not None:
            self.stream.synchronize()
        for g, s in zip(self.generators, states):
            g.set_state(s)

    def actor_idle_frac(self) -> float:
        total = self.idle_s + self.busy_s
        return self.idle_s / total if total > 0 else 0.0

    def cache_sizes(self) -> Dict[int, int]:
        return {0: self.rollout.compiled.cache_size()}

    def _window(self) -> Tuple[Dict[str, torch.Tensor], Any, int]:
        """One rollout with the newest version; the segment copied off the
        graph's buffers."""
        staged, version = self.broadcast.fetch(self.index)
        if staged is not None and staged is not self._installed:
            staged.copy_into(self._live)
            self._installed = staged
        self._carry, traj, last_obs, stats = self.rollout(self._carry)
        segment = {k: v.clone() for k, v in traj.items()}
        segment.update({f"last_{k}": v.clone() for k, v in last_obs.items()})
        return segment, stats, version

    def run(self) -> None:
        from sheeprl_tpu_torch.envs.device.anakin import episode_stats_from_device

        try:
            windows = 0
            with on_stream(self.stream):
                while not self.stop_event.is_set():
                    t0 = time.perf_counter()
                    with self.guard.window(windows > 0):
                        segment, stats, version = self._window()
                    if self.stream is not None:
                        # busy/idle measure the device's rollout, not the enqueue
                        self.stream.synchronize()
                    windows += 1
                    t1 = time.perf_counter()
                    self.busy_s += t1 - t0
                    if self.stats_sink is not None:
                        rets, lens = episode_stats_from_device(stats)
                        if rets.size:
                            self.stats_sink(list(zip(rets.tolist(), lens.tolist())))
                    meta = {"version": version, "worker": self.index, "env_steps": self.env_steps_per_segment,
                            "generation": 0}
                    if self.stop_event.is_set():
                        break
                    self.traj_queue.put(segment, meta=meta)
                    self.segments_pushed += 1
                    self.env_steps += self.env_steps_per_segment
                    self.idle_s += time.perf_counter() - t1
        except ServiceStopped:
            pass
        except BaseException as e:  # noqa: BLE001 — surfaced by the runner
            if not self.stop_event.is_set():
                self.error = e
