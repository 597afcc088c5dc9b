"""The in-process policy service: warm ladder, batch, serve (counterpart of
``sheeprl_tpu/serve/service.py``).

:class:`PolicyService` glues the pieces together around one model:

* a :class:`~sheeprl_tpu_torch.serve.players.PolicyPlayer`,
* the batch-size ladder, each rung built by :meth:`warm_up` (one captured
  CUDA graph per rung for DreamerV3 on the card) before traffic is admitted,
* an :class:`~sheeprl_tpu_torch.serve.batcher.AdmissionQueue` and one
  dispatcher thread doing pad-to-ladder coalescing,
* per-session latent carries for stateful players (dreamer_v3).

Hot reload on a new ``COMMIT`` (the JAX package's ``CommitWatcher``) is not
ported yet: with ``serve.watch_commits`` on, :meth:`start` says so on stderr
and the service keeps serving the snapshot it loaded.
"""

from __future__ import annotations

import sys
import threading
import time
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
from sheeprl_tpu_torch.serve.reload import ParamStore

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
        self.watch_requested = bool(serve_cfg.get("watch_commits", True)) and ckpt_root is not None
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
        from sheeprl_tpu_torch.serve.loader import load_policy, resolve_checkpoint

        ckpt = resolve_checkpoint(checkpoint_path)
        fabric, cfg, _, player = load_policy(ckpt, overrides)
        return cls(fabric, cfg, player, ckpt_root=ckpt.parent)

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
        if self.watch_requested:
            print(
                "serve.watch_commits: hot reload is not ported to sheeprl_tpu_torch yet; "
                f"serving checkpoint step {self.store.step} until restarted",
                file=sys.stderr,
                flush=True,
            )
        self._dispatcher = threading.Thread(target=self._dispatch_loop, name="sheeprl-serve-dispatch", daemon=True)
        self._dispatcher.start()
        self._started = True
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
            params, _, _ = self.store.snapshot()
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

    # -- observability -------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            served, batches = self._served, self._batches
            padded, errors = self._padded_rows, self._errors
            rungs = {str(size): n for size, n in sorted(self._rungs.items())}
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
            "batch_ladder": list(self.ladder),
            "sessions": sessions,
        }
        out.update(self.latency.percentiles((50, 99)))
        return out


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
