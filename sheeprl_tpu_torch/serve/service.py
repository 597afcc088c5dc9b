"""The in-process policy service: warm ladder, batch, serve (counterpart of
``sheeprl_tpu/serve/service.py``).

:class:`PolicyService` glues the pieces together around one model:

* a :class:`~sheeprl_tpu_torch.serve.players.PolicyPlayer`,
* the batch-size ladder, each rung built by :meth:`warm_up` (one captured
  CUDA graph per rung for DreamerV3 on the card) before traffic is admitted,
* an :class:`~sheeprl_tpu_torch.serve.batcher.AdmissionQueue` and one
  dispatcher thread doing pad-to-ladder coalescing,
* a :class:`~sheeprl_tpu_torch.serve.reload.CommitWatcher` installing the
  parameters of a new ``COMMIT`` into the served (captured) step between
  batches, without dropping a request (``serve.watch_commits``),
* per-session latent carries for stateful players (dreamer_v3), with a
  CRC-stamped snapshot of one session's carry to migrate it
  (:meth:`PolicyService.get_session_carry` / :meth:`restore_session_carry`),
* ``Serve/*`` metrics through the telemetry hub (source ``serve``).
"""

from __future__ import annotations

import threading
import time
import zlib
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from sheeprl_tpu_torch.serve.batcher import (
    AdmissionQueue,
    LatencyTracker,
    ServiceStopped,
    _Request,
    pick_ladder_size,
)
from sheeprl_tpu_torch.serve.reload import CommitWatcher, ParamStore, StagedParams, live_tensors
from sheeprl_tpu_torch.telemetry.hub import HUB

DEFAULT_LADDER = (1, 8, 32, 128)


class PolicyService:
    """Continuous-batching policy server around one committed checkpoint."""

    def __init__(self, fabric: Any, cfg: Any, player: Any, ckpt_root: Optional[Any] = None):
        self.fabric = fabric
        self.cfg = cfg
        self.player = player
        self.ckpt_root = ckpt_root
        serve_cfg = cfg.get("serve") or {}
        ladder = tuple(int(b) for b in serve_cfg.get("batch_ladder", DEFAULT_LADDER))
        self.ladder = tuple(sorted(set(ladder)))
        self.max_batch = self.ladder[-1]
        self.max_wait_s = float(serve_cfg.get("max_wait_ms", 5.0)) / 1e3
        self.default_greedy = bool(serve_cfg.get("greedy", True))
        self.queue = AdmissionQueue(int(serve_cfg.get("max_pending", 1024)))
        self.store = ParamStore(player.params, step=player.checkpoint_step)
        self.latency = LatencyTracker(int(serve_cfg.get("latency_window", 8192)))
        self._watch = bool(serve_cfg.get("watch_commits", True)) and ckpt_root is not None
        self.watcher: Optional[CommitWatcher] = None
        if ckpt_root is not None:
            self.watcher = CommitWatcher(
                ckpt_root,
                self.store,
                self._load_player_params,
                poll_s=float(serve_cfg.get("reload_poll_s", 2.0)),
                failure_threshold=int(serve_cfg.get("reload_failure_threshold", 3)),
                breaker_reset_s=float(serve_cfg.get("reload_breaker_reset_s", 30.0)),
                quarantine=bool(serve_cfg.get("quarantine_poisoned", True)),
            )
        self._sessions: Dict[str, tuple] = {}
        self._sessions_lock = threading.Lock()
        self._dispatcher: Optional[threading.Thread] = None
        self._seed_lock = threading.Lock()
        self._seed = int(cfg.get("seed", 0) or 0)
        self._stats_lock = threading.Lock()
        self._served = 0
        self._batches = 0
        self._padded_rows = 0
        self._errors = 0
        self._rungs: Counter = Counter()
        self._started = False

    @classmethod
    def from_checkpoint(cls, checkpoint_path: Any, overrides: Sequence[str] = ()) -> "PolicyService":
        from sheeprl_tpu_torch.serve.loader import checkpoint_root, load_policy, resolve_checkpoint

        ckpt = resolve_checkpoint(checkpoint_path)
        fabric, cfg, _, player = load_policy(ckpt, overrides)
        return cls(fabric, cfg, player, ckpt_root=checkpoint_root(ckpt) if ckpt.is_dir() else None)

    # -- lifecycle -----------------------------------------------------------
    def warm_up(self) -> None:
        """Build the step at every ladder rung before traffic: the kernels'
        builds joined, then each rung dispatched once, which captures its
        CUDA graph on the card (cuDNN's algorithm choice and the kernels'
        first launch happen in that first call)."""
        from sheeprl_tpu_torch.parallel.compile import warmup_batch_ladder

        warmup_batch_ladder(self.player.step_batch, self.player.batch_specs, self.ladder,
                            pool=self.fabric.compile_pool)

    def start(self, warm: bool = True) -> "PolicyService":
        if self._started:
            return self
        if warm:
            self.warm_up()
        self._dispatcher = threading.Thread(target=self._dispatch_loop, name="sheeprl-serve-dispatch", daemon=True)
        self._dispatcher.start()
        if self.watcher is not None and self._watch:
            self.watcher.start()
        self._started = True
        # /v1/stats' numbers (and the server's /metrics) through the hub
        HUB.register("serve", self.hub_metrics)
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop admitting, serve (or fail) the backlog, join the dispatcher."""
        pending = self.queue.close()
        if self._dispatcher is not None:
            self._dispatcher.join(timeout)
        if drain and pending:
            for start in range(0, len(pending), self.max_batch):
                self._dispatch(pending[start : start + self.max_batch])
        else:
            for req in pending:
                req.fail(ServiceStopped("service stopped before dispatch"))
        if self.watcher is not None:
            self.watcher.stop()
        HUB.unregister("serve")
        self._started = False

    def __enter__(self) -> "PolicyService":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    # -- request path --------------------------------------------------------
    def submit(
        self,
        obs: Dict[str, np.ndarray],
        greedy: Optional[bool] = None,
        session: Optional[str] = None,
        block: bool = True,
        timeout: Optional[float] = None,
    ) -> _Request:
        """Enqueue one observation; returns a request handle whose
        ``.wait(timeout)`` gives the action.  Raises ``QueueFull`` under
        backpressure."""
        req = _Request(obs, self.default_greedy if greedy is None else greedy, session)
        self.queue.put(req, block=block, timeout=timeout)
        return req

    def act(
        self,
        obs: Dict[str, np.ndarray],
        greedy: Optional[bool] = None,
        session: Optional[str] = None,
        timeout: Optional[float] = 30.0,
        block: bool = True,
    ) -> np.ndarray:
        """Submit and wait.  ``block=False`` raises ``QueueFull`` on a full
        admission queue instead of blocking the caller."""
        return self.submit(obs, greedy=greedy, session=session, block=block).wait(timeout)

    def reset_session(self, session: str) -> None:
        """Drop a stateful session's latent carry (episode boundary)."""
        with self._sessions_lock:
            self._sessions.pop(session, None)

    # -- carry migration -----------------------------------------------------
    def get_session_carry(self, session: str) -> Optional[Dict[str, Any]]:
        """Host-side, CRC-stamped snapshot of one session's latent carry:
        packed base64 leaves in ``carry_spec`` order plus a CRC over the raw
        buffers, so a torn copy cannot resurrect a session with a corrupted
        latent state.  None for unknown sessions and stateless players."""
        if not self.player.stateful:
            return None
        with self._sessions_lock:
            carry = self._sessions.get(session)
        if carry is None:
            return None
        from sheeprl_tpu_torch.serve.server import encode_array

        leaves = [np.ascontiguousarray(np.asarray(c)) for c in carry]
        return {
            "session": session,
            "algo": self.player.algo,
            "generation": self.store.generation,
            "carry": [encode_array(leaf, packed=True) for leaf in leaves],
            "crc": _carry_crc(leaves),
        }

    def restore_session_carry(self, session: str, snapshot: Dict[str, Any]) -> None:
        """Install a :meth:`get_session_carry` snapshot as ``session``'s carry,
        checking the algo, each leaf's shape and dtype against ``carry_spec``
        and the CRC stamp.  Raises ValueError on any mismatch."""
        if not self.player.stateful:
            raise ValueError(f"player '{self.player.algo}' is stateless: no carry to restore")
        algo = snapshot.get("algo")
        if algo not in (None, self.player.algo):
            raise ValueError(f"carry snapshot is for algo '{algo}', not '{self.player.algo}'")
        from sheeprl_tpu_torch.serve.server import decode_array

        spec = self.player.carry_spec
        raw = snapshot.get("carry")
        if not isinstance(raw, (list, tuple)) or len(raw) != len(spec):
            got = len(raw) if isinstance(raw, (list, tuple)) else type(raw).__name__
            raise ValueError(f"carry snapshot has {got} leaves, expected {len(spec)}")
        leaves = []
        for i, (value, (shape, dtype)) in enumerate(zip(raw, spec)):
            leaf = np.ascontiguousarray(decode_array(value))
            want = (1, *shape)
            if leaf.shape != want or leaf.dtype != np.dtype(dtype):
                raise ValueError(f"carry leaf {i} is {leaf.shape}/{leaf.dtype}, expected {want}/{dtype}")
            leaves.append(leaf)
        stamp = snapshot.get("crc")
        if stamp is None or int(stamp) != _carry_crc(leaves):
            raise ValueError("carry snapshot failed its CRC check (torn or corrupted copy)")
        with self._sessions_lock:
            self._sessions[session] = tuple(leaves)

    # -- dispatch ------------------------------------------------------------
    def _next_seed(self) -> int:
        with self._seed_lock:
            self._seed = (self._seed + 1) % (2**31 - 1)
            return self._seed

    def _dispatch_loop(self) -> None:
        while True:
            batch = self.queue.get_batch(self.max_batch, self.max_wait_s)
            if not batch:
                if self.queue.closed:
                    return
                continue
            if self.player.stateful:
                # two requests of one session must not share a batch: both
                # would read the same carry and the second write would drop
                # the first latent transition — chain them through waves
                for wave in _session_waves(batch):
                    self._dispatch(wave)
            else:
                self._dispatch(batch)

    def _dispatch(self, batch: List[_Request]) -> None:
        batch = [r for r in batch if not r.cancelled]
        if not batch:
            return
        player = self.player
        try:
            k = len(batch)
            size = pick_ladder_size(k, self.ladder)
            raw = {key: np.stack([np.asarray(r.obs[key]) for r in batch]) for key in player.obs_spec}
            obs = {key: _pad_rows(v, size) for key, v in player.prepare(raw).items()}
            if player.stateful:
                rows = [self._session_carry(r.session) for r in batch]
                carry = tuple(
                    _pad_rows(np.concatenate([row[i] for row in rows], axis=0), size)
                    for i in range(len(player.carry_spec))
                )
            else:
                carry = ()
            greedy = np.zeros((size,), bool)
            greedy[:k] = [r.greedy for r in batch]
            # the whole step under the store's lock: a reload installs
            # between batches, so a batch finishes on the generation it began
            with self.store.serving() as (params, _, _):
                new_carry, actions = player.step_batch(params, carry, obs, self._next_seed(), greedy)
            env_actions = player.postprocess(actions[:k])
            now = time.perf_counter()
            for i, req in enumerate(batch):
                if player.stateful and req.session is not None:
                    with self._sessions_lock:
                        self._sessions[req.session] = tuple(c[i : i + 1] for c in new_carry)
                self.latency.record(now - req.enqueued)
                req.resolve(np.asarray(env_actions[i]))
            with self._stats_lock:
                self._served += k
                self._batches += 1
                self._padded_rows += size - k
                self._rungs[size] += 1
        except BaseException as e:
            with self._stats_lock:
                self._errors += len(batch)
            for req in batch:
                req.fail(e)

    def _session_carry(self, session: Optional[str]) -> tuple:
        if session is not None:
            with self._sessions_lock:
                carry = self._sessions.get(session)
            if carry is not None:
                return carry
        return self.player.zero_carry_row()

    def _load_player_params(self, step_dir: Any) -> StagedParams:
        """Hot-reload read, on the watcher's thread: the snapshot on the host,
        the player's modules' tensors taken out of it and staged beside the
        live ones (pinned memory, then the card on a side stream)."""
        from sheeprl_tpu_torch.serve.loader import load_state

        state = load_state(step_dir, self.cfg, "cpu")
        return StagedParams(live_tensors(self.player.params), self.player.extract(state["agent"]))

    # -- observability -------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        from sheeprl_tpu_torch.ops import LAUNCH_COUNTERS
        from sheeprl_tpu_torch.telemetry.monitors import COMPILE_MONITOR

        with self._stats_lock:
            served, batches = self._served, self._batches
            padded, errors = self._padded_rows, self._errors
            rungs = {str(size): n for size, n in sorted(self._rungs.items())}
        n_exe, compile_s = COMPILE_MONITOR.totals()
        with self._sessions_lock:
            sessions = len(self._sessions)
        out = {
            "algo": self.player.algo,
            "device": str(self.player.device),
            "served": served,
            "batches": batches,
            "errors": errors,
            "pending": len(self.queue),
            "avg_batch": round(served / batches, 3) if batches else 0.0,
            "padded_frac": round(padded / (served + padded), 4) if served + padded else 0.0,
            "rungs": rungs,
            "generation": self.store.generation,
            "checkpoint_step": self.store.step,
            "reloads": self.watcher.reloads if self.watcher else 0,
            "reload_error": self.watcher.last_error if self.watcher else None,
            # the reload breaker open or half-open: new commits fail to load
            # and the server keeps serving the old parameters
            "degraded": self.watcher.degraded if self.watcher else False,
            "reload_breaker": self.watcher.breaker.snapshot() if self.watcher else None,
            "quarantined": self.watcher.quarantined if self.watcher else 0,
            "reload_pause_ms": round(self.store.last_install_s * 1e3, 3),
            "batch_ladder": list(self.ladder),
            "compile_executables": n_exe,
            "compile_time_s": round(compile_s, 3),
            "sessions": sessions,
            # this process's kernel launches (a replay credited with its
            # capture's), readable from outside a fleet's replica
            "kernel_launches": {name: n for counter in LAUNCH_COUNTERS for name, n in counter.items()},
        }
        out.update(self.latency.percentiles((50, 99)))
        return out

    def hub_metrics(self) -> Dict[str, float]:
        """The numeric subset of :meth:`stats` as ``Serve/*`` hub metrics
        (the hub source registered by :meth:`start`)."""
        s = self.stats()
        out: Dict[str, float] = {}
        for key in ("served", "batches", "errors", "pending", "avg_batch", "padded_frac", "generation",
                    "checkpoint_step", "reloads", "quarantined", "sessions", "p50_ms", "p99_ms"):
            value = s.get(key)
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                out[f"Serve/{key}"] = float(value)
        out["Serve/degraded"] = 1.0 if s.get("degraded") else 0.0
        return out


def _carry_crc(leaves: Sequence[np.ndarray]) -> int:
    """CRC32 over every carry leaf's shape/dtype header and raw C-order
    bytes — the integrity stamp on a migrated session carry."""
    crc = 0
    for leaf in leaves:
        crc = zlib.crc32(f"{leaf.shape}:{leaf.dtype}".encode(), crc)
        crc = zlib.crc32(np.ascontiguousarray(leaf).tobytes(), crc)
    return crc & 0xFFFFFFFF


def _session_waves(batch: List[_Request]) -> List[List[_Request]]:
    """Split a batch into waves holding at most one request per (non-None)
    session, keeping arrival order within each session."""
    waves: List[List[_Request]] = []
    sessions: List[set] = []
    for req in batch:
        for wave, seen in zip(waves, sessions):
            if req.session is None or req.session not in seen:
                wave.append(req)
                if req.session is not None:
                    seen.add(req.session)
                break
        else:
            waves.append([req])
            sessions.append(set() if req.session is None else {req.session})
    return waves


def _pad_rows(x: np.ndarray, size: int) -> np.ndarray:
    """Pad the leading (batch) axis up to ``size`` with zeros."""
    x = np.asarray(x)
    if x.shape[0] == size:
        return x
    pad = np.zeros((size - x.shape[0], *x.shape[1:]), dtype=x.dtype)
    return np.concatenate([x, pad], axis=0)
