"""Health-checked routing front over N policy-server replicas (counterpart
of ``sheeprl_tpu/serve/fleet/router.py``).

The fleet's availability story lives here:

* **dispatch** — stateless requests go to the least-loaded routable
  replica (in-flight count, stable tie-break); session-bearing requests
  stick to their assigned replica via rendezvous (highest-random-weight)
  hashing, so replica-set churn only moves the sessions of the replica
  that changed;
* **eject / readmit** — every replica carries its own
  :class:`~sheeprl_tpu_torch.resilience.retry.CircuitBreaker`: consecutive
  forward/probe failures open it (ejected — no traffic), the cool-down's
  half-open probe readmits it on the first success.  A background prober
  polls each replica's ``/healthz`` (the same surface the single-server
  deployment exposes, ``degraded``/``reload_breaker`` included);
* **failover** — a failed forward is retried on the next-best replica
  (``serve.fleet.route_retries`` distinct replicas) before the router
  answers 503 ``replica_unavailable`` — which the client retries, so a
  replica death costs latency, never a dropped request;
* **carry migration** — for stateful players the router mirrors each
  session's CRC-stamped latent carry (piggybacked on act responses);
  when a session's replica dies, the router replays the ``/v1/reset`` +
  ``/v1/session_carry`` rebuild contract onto the survivor it re-routes
  to, so the killed replica loses at most one in-flight step, never the
  session.  A session whose slot came back as a respawned process is
  migrated onto it the same way: the new process holds no carry (the JAX
  router keeps routing such a session to its slot with no replay, so it
  restarts from a zero carry);
* **rolling reload** — a :class:`~sheeprl_tpu_torch.serve.reload.CommitWatcher`
  (param "store" holding just the fleet's deployed step) walks replicas
  one at a time: drain → ``/v1/reload`` → verify → undrain.  Any failure
  halts the rollout with old params still serving everywhere, and the
  watcher's breaker/quarantine machinery takes over.  Each replica installs
  the snapshot into its captured served step (``serve/reload.py``): no
  replica recaptures.

Chaos sites: ``serve.router`` fires at the router's own request handling,
``serve.replica`` fires on every router→replica leg (the knob drills use
to simulate replica kill/hang without touching the processes).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Sequence, Tuple

from sheeprl_tpu_torch.resilience.faults import fault_point
from sheeprl_tpu_torch.resilience.retry import CircuitBreaker


def assign_replica(session: str, rids: Sequence[str]) -> Optional[str]:
    """Rendezvous (highest-random-weight) hash: the replica id in ``rids``
    with the largest ``blake2b(session@rid)`` weight (a seeded digest, not
    Python's ``hash()`` — assignments must agree across processes and
    interpreter restarts).

    The property the fleet needs: removing one replica re-assigns ONLY the
    sessions that were on it (every other session's argmax is untouched),
    and adding one steals only the sessions whose new weight wins — no
    modulo-style global reshuffle on churn.
    """
    import hashlib

    if not rids:
        return None
    return max(
        sorted(rids),
        key=lambda rid: hashlib.blake2b(
            f"{session}@{rid}".encode(), digest_size=8
        ).digest(),
    )


class ReplicaState:
    """One replica as the router sees it: address, breaker, load."""

    def __init__(self, rid: str, url: str, eject_threshold: int = 3, readmit_s: float = 5.0):
        self.rid = rid
        self.url = url.rstrip("/")
        self.breaker = CircuitBreaker(
            failure_threshold=eject_threshold,
            reset_timeout_s=readmit_s,
            name=f"serve.fleet.{rid}",
        )
        self._lock = threading.Lock()
        self._inflight = 0
        #: router stopped sending traffic (rolling reload in progress)
        self.draining = False
        #: at least one successful /healthz since (re)registration — a
        #: replica is never routable before its first good probe
        self.probed = False
        self.last_health: Dict[str, Any] = {}

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def begin(self) -> None:
        with self._lock:
            self._inflight += 1

    def end(self) -> None:
        with self._lock:
            self._inflight -= 1

    @property
    def routable(self) -> bool:
        """May NEW traffic be sent here right now?"""
        return self.probed and not self.draining and self.breaker.allow()

    @property
    def checkpoint_step(self) -> int:
        return int(self.last_health.get("checkpoint_step", -1))

    def describe(self) -> Dict[str, Any]:
        return {
            "url": self.url,
            "routable": self.routable,
            "draining": self.draining,
            "probed": self.probed,
            "inflight": self.inflight,
            "breaker": self.breaker.snapshot(),
            "checkpoint_step": self.checkpoint_step,
            "degraded": bool(self.last_health.get("degraded", False)),
        }


class FleetRouter:
    """Health-checked, session-affine dispatch over a set of replicas.

    ``addresses`` maps stable replica ids (slot names like ``r0`` — a
    respawned process keeps its slot's id, so session assignments survive
    replica churn) to base URLs.  ``cfg`` is a composed run config whose
    ``serve.fleet`` group supplies the knobs; ``ckpt_root`` (optional)
    arms fleet-wide rolling hot reload on that run's commit stream.
    """

    def __init__(self, addresses: Dict[str, str], cfg: Any, ckpt_root: Optional[Any] = None):
        serve_cfg = (cfg.get("serve") or {}) if hasattr(cfg, "get") else {}
        fleet_cfg = serve_cfg.get("fleet") or {}
        self.cfg = cfg
        self.health_poll_s = float(fleet_cfg.get("health_poll_s", 1.0))
        self.health_timeout_s = float(fleet_cfg.get("health_timeout_s", 5.0))
        self.eject_threshold = int(fleet_cfg.get("eject_threshold", 3))
        self.readmit_s = float(fleet_cfg.get("readmit_s", 5.0))
        self.route_retries = max(1, int(fleet_cfg.get("route_retries", 3)))
        self.request_timeout_s = float(fleet_cfg.get("request_timeout_s", 60.0))
        self.drain_timeout_s = float(fleet_cfg.get("drain_timeout_s", 30.0))
        self.reload_poll_s = float(fleet_cfg.get("reload_poll_s", 2.0))
        self.carry_mirror = bool(fleet_cfg.get("carry_mirror", True))
        self._reload_failure_threshold = int(serve_cfg.get("reload_failure_threshold", 3))
        self._reload_breaker_reset_s = float(serve_cfg.get("reload_breaker_reset_s", 30.0))
        self._quarantine = bool(serve_cfg.get("quarantine_poisoned", True))
        self.ckpt_root = ckpt_root
        self._lock = threading.Lock()
        self._replicas: Dict[str, ReplicaState] = {}
        for rid, url in addresses.items():
            self._replicas[rid] = ReplicaState(
                rid, url, eject_threshold=self.eject_threshold, readmit_s=self.readmit_s
            )
        # session -> {"rid": ..., "carry": <snapshot|None>, "steps": n}
        self._sessions: Dict[str, Dict[str, Any]] = {}
        self._sessions_lock = threading.Lock()
        # fleet identity, learned from the first healthy probe
        self._spec: Optional[Dict[str, Any]] = None
        self.stateful = False
        self.watcher = None  # built in start() once the deployed step is known
        self._stop = threading.Event()
        self._prober: Optional[threading.Thread] = None
        self._started = False
        # counters (stats/metrics; guarded by _counters_lock)
        self._counters_lock = threading.Lock()
        self._routed = 0
        self._failovers = 0
        self._unroutable = 0
        self._ejects = 0
        self._readmits = 0
        self._migrations = 0
        self._rolling_reloads = 0
        self._reload_halts = 0
        self._replicas_reloaded = 0
        self._respawns = 0

    # -- replica-set management ----------------------------------------------
    def replica_list(self) -> List[ReplicaState]:
        with self._lock:
            return [self._replicas[rid] for rid in sorted(self._replicas)]

    def get_replica(self, rid: str) -> Optional[ReplicaState]:
        with self._lock:
            return self._replicas.get(rid)

    def mark_dead(self, rid: str) -> None:
        """The supervisor observed the process die: stop routing NOW
        instead of waiting for the breaker to accumulate probe failures."""
        rep = self.get_replica(rid)
        if rep is not None:
            rep.probed = False

    def replace_replica(self, rid: str, url: str) -> None:
        """A respawned process took over slot ``rid`` at a new address.
        Fresh breaker, unprobed (no traffic until the first good probe);
        the slot id is stable so rendezvous assignments keep their
        meaning."""
        with self._lock:
            self._replicas[rid] = ReplicaState(
                rid, url, eject_threshold=self.eject_threshold, readmit_s=self.readmit_s
            )

    def note_respawn(self) -> None:
        with self._counters_lock:
            self._respawns += 1

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "FleetRouter":
        if self._started:
            return self
        self._started = True
        for rep in self.replica_list():
            self._probe(rep)
        if self.ckpt_root is not None:
            from sheeprl_tpu_torch.serve.reload import CommitWatcher, ParamStore

            # the fleet's "params" are just the deployed checkpoint step: the
            # watcher machinery (discovery, CRC verify, breaker, quarantine)
            # is reused verbatim, with _rollout_to as the load function —
            # a failed rollout is a failed load, poison is quarantined, and
            # the breaker's cool-down paces retries exactly like a single
            # server's reload path
            deployed = [r.checkpoint_step for r in self.replica_list() if r.probed]
            self._fleet_store = ParamStore(None, step=max(deployed) if deployed else -1)
            self.watcher = CommitWatcher(
                self.ckpt_root,
                self._fleet_store,
                lambda step_dir: _Deployed(self._rollout_to(step_dir)),
                poll_s=self.reload_poll_s,
                on_reload=self._note_rollout,
                failure_threshold=self._reload_failure_threshold,
                breaker_reset_s=self._reload_breaker_reset_s,
                quarantine=self._quarantine,
            )
            self.watcher.start()
        self._prober = threading.Thread(
            target=self._probe_loop, name="sheeprl-fleet-prober", daemon=True
        )
        self._prober.start()
        from sheeprl_tpu_torch.telemetry import HUB

        HUB.register("fleet", self.hub_metrics)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self.watcher is not None:
            self.watcher.stop()
        if self._prober is not None:
            self._prober.join(self.health_poll_s * 2 + 1.0)
        from sheeprl_tpu_torch.telemetry import HUB

        HUB.unregister("fleet")
        self._started = False

    def wait_healthy(self, min_replicas: int = 1, timeout: float = 120.0) -> bool:
        """Block until ``min_replicas`` replicas are routable (startup
        barrier for the CLI/bench/tests)."""
        deadline = time.monotonic() + float(timeout)
        while time.monotonic() < deadline:
            if sum(1 for r in self.replica_list() if r.routable) >= min_replicas:
                return True
            for rep in self.replica_list():
                if not rep.probed:
                    self._probe(rep)
            if self._stop.wait(0.25):
                return False
        return False

    # -- probing ---------------------------------------------------------------
    def _probe_loop(self) -> None:
        while not self._stop.wait(self.health_poll_s):
            for rep in self.replica_list():
                self._probe(rep)

    def _probe(self, rep: ReplicaState) -> bool:
        try:
            status, body = self._forward(
                rep, "GET", "/healthz", timeout=self.health_timeout_s
            )
            if status != 200 or not body.get("ok", False):
                raise IOError(f"healthz answered {status}")
        except Exception:
            self._note_failure(rep)
            return False
        rep.last_health = body
        rep.probed = True
        self._note_success(rep)
        if self._spec is None and body.get("obs_spec"):
            # fleet identity: every replica serves the same model, so the
            # first healthy answer defines the contract clients see
            self._spec = {
                "algo": body.get("algo"),
                "obs_spec": body.get("obs_spec"),
                "action_shape": body.get("action_shape"),
                "stateful": bool(body.get("stateful", False)),
            }
            self.stateful = self._spec["stateful"]
        return True

    def _note_failure(self, rep: ReplicaState) -> None:
        before = rep.breaker.state
        rep.breaker.record_failure()
        if before != CircuitBreaker.OPEN and rep.breaker.state == CircuitBreaker.OPEN:
            with self._counters_lock:
                self._ejects += 1

    def _note_success(self, rep: ReplicaState) -> None:
        before = rep.breaker.state
        rep.breaker.record_success()
        if before != CircuitBreaker.CLOSED:
            with self._counters_lock:
                self._readmits += 1

    # -- transport -------------------------------------------------------------
    def _forward(
        self,
        rep: ReplicaState,
        method: str,
        path: str,
        data: Optional[bytes] = None,
        timeout: Optional[float] = None,
    ) -> Tuple[int, Dict[str, Any]]:
        """One router→replica HTTP leg.  Connection-level failures raise;
        HTTP error statuses return ``(code, parsed-body)`` — the caller
        decides which are failover-worthy.  ``serve.replica`` is the chaos
        site on this leg: an injected raise/hang here looks exactly like a
        dead/wedged replica."""
        fault_point("serve.replica")
        req = urllib.request.Request(
            rep.url + path,
            data=data,
            method=method,
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(
                req, timeout=self.request_timeout_s if timeout is None else timeout
            ) as resp:
                return resp.status, json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            raw = b""
            try:
                raw = e.read() or b""
            except Exception:
                pass
            try:
                payload = json.loads(raw)
            except Exception:
                payload = {"error": raw.decode("utf-8", "replace")[:512] or str(e)}
            return e.code, payload

    # -- dispatch --------------------------------------------------------------
    def _pick(self, session: Optional[str], tried: set) -> Optional[ReplicaState]:
        """The routing decision.  Sessions: the stored assignment while its
        replica lives, else rendezvous over the live set (lazy migration —
        a readmitted replica does NOT yank its old sessions back).
        Stateless: least in-flight, stable tie-break."""
        reps = self.replica_list()
        if session is not None:
            with self._sessions_lock:
                entry = self._sessions.get(session)
            if entry is not None and entry["rid"] not in tried:
                rep = self.get_replica(entry["rid"])
                # draining is temporary (rolling reload): keep the sticky
                # target, the act path waits the drain out
                if rep is not None and (rep.routable or (rep.probed and rep.draining)):
                    return rep
            cands = [r for r in reps if r.routable and r.rid not in tried]
            rid = assign_replica(session, [r.rid for r in cands])
            return next((r for r in cands if r.rid == rid), None)
        cands = [r for r in reps if r.routable and r.rid not in tried]
        if not cands:
            return None
        return min(cands, key=lambda r: (r.inflight, r.rid))

    def _wait_not_draining(self, rep: ReplicaState, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        while rep.draining:
            if time.monotonic() >= deadline or self._stop.is_set():
                return False
            time.sleep(0.02)
        return True

    def _place_session(self, session: str, rep: ReplicaState) -> None:
        """Bind ``session`` to ``rep``, replaying the mirrored carry when
        this is a migration (the old replica died mid-session).  The
        rebuild contract is exactly what a fresh client would do: /v1/reset
        to drop any stale state, then /v1/session_carry to install the
        last mirrored (pre-loss) latent carry.  Failures raise — the act
        loop treats them as a failed forward and fails over again."""
        with self._sessions_lock:
            entry = self._sessions.get(session)
            if entry is not None and entry["rep"] is rep:
                return
            carry = entry.get("carry") if entry is not None else None
            # a new replica, or the same slot served by a respawned process
            migrating = entry is not None
        if migrating and self.stateful:
            body = json.dumps({"session": session}).encode()
            status, payload = self._forward(rep, "POST", "/v1/reset", body)
            if status != 200:
                raise IOError(f"migration reset answered {status}: {payload}")
            if carry is not None:
                body = json.dumps({"session": session, "snapshot": carry}).encode()
                status, payload = self._forward(rep, "POST", "/v1/session_carry", body)
                if status != 200:
                    raise IOError(f"carry restore answered {status}: {payload}")
            with self._counters_lock:
                self._migrations += 1
        with self._sessions_lock:
            self._sessions[session] = {"rid": rep.rid, "rep": rep, "carry": carry}

    def act(self, raw: bytes) -> Tuple[int, Dict[str, Any]]:
        """Route one ``/v1/act`` body; returns ``(status, payload)``.

        ``serve.router`` is the chaos site at the router's own front door.
        The loop tries up to ``route_retries`` DISTINCT replicas; only
        requests that were provably never dispatched fail over (connection
        errors, 429 shed, 5xx from a replica that never batched it — the
        replica's own act path answers those before any carry advances), so
        a failover can never double-step a session.
        """
        fault_point("serve.router")
        try:
            body = json.loads(raw or b"{}")
        except Exception as e:
            return 400, {"error": f"invalid JSON body: {e}"}
        session = body.get("session")
        session = None if session is None else str(session)
        mirror = self.carry_mirror and self.stateful and session is not None
        if mirror and not body.get("return_carry"):
            body["return_carry"] = True
            raw = json.dumps(body).encode()
        tried: set = set()
        last_error: Optional[str] = None
        for _ in range(self.route_retries):
            rep = self._pick(session, tried)
            if rep is None:
                break
            if rep.draining and not self._wait_not_draining(rep, self.request_timeout_s):
                tried.add(rep.rid)
                last_error = f"replica {rep.rid} stuck draining"
                continue
            try:
                if session is not None:
                    self._place_session(session, rep)
                rep.begin()
                try:
                    status, payload = self._forward(rep, "POST", "/v1/act", raw)
                finally:
                    rep.end()
            except Exception as e:
                # connection refused/reset, timeout, injected serve.replica
                # fault: the replica never answered — fail over
                self._note_failure(rep)
                tried.add(rep.rid)
                last_error = f"{type(e).__name__}: {e}"
                with self._counters_lock:
                    self._failovers += 1
                continue
            if status < 400:
                self._note_success(rep)
                if mirror and "carry" in payload:
                    snapshot = payload.pop("carry")
                    with self._sessions_lock:
                        entry = self._sessions.get(session)
                        if entry is not None and entry["rep"] is rep:
                            entry["carry"] = snapshot
                with self._counters_lock:
                    self._routed += 1
                payload["replica"] = rep.rid
                return status, payload
            if status == 429 or status >= 500:
                # 429: the replica shed the request before dispatch; 5xx:
                # its act path failed before resolving — either way the
                # request never advanced a carry, so another replica may
                # serve it.  Only 5xx is breaker evidence (429 is load, not
                # illness).
                if status >= 500:
                    self._note_failure(rep)
                tried.add(rep.rid)
                last_error = f"replica {rep.rid} answered {status}: {payload.get('error')}"
                with self._counters_lock:
                    self._failovers += 1
                continue
            return status, payload  # other 4xx: the request itself is bad
        with self._counters_lock:
            self._unroutable += 1
        return 503, {
            "error": "replica_unavailable: no routable replica "
            f"(tried {sorted(tried) or 'none'}; last: {last_error})"
        }

    def reset(self, session: str) -> Tuple[int, Dict[str, Any]]:
        """Drop a session fleet-wide: the router's assignment + mirror, and
        the assigned replica's carry (best-effort — a dead replica took its
        carry with it anyway)."""
        with self._sessions_lock:
            entry = self._sessions.pop(session, None)
        if entry is not None:
            rep = self.get_replica(entry["rid"])
            if rep is not None and rep.probed:
                try:
                    self._forward(
                        rep, "POST", "/v1/reset", json.dumps({"session": session}).encode()
                    )
                except Exception:
                    pass
        return 200, {"ok": True}

    # -- rolling reload --------------------------------------------------------
    def reload_once(self) -> Tuple[int, Dict[str, Any]]:
        """Force one commit-watch poll (the fleet spelling of
        ``POST /v1/reload``)."""
        if self.watcher is None:
            return 200, {"reloaded": False, "error": "rolling reload disabled (no ckpt_root)"}
        gen = self.watcher.poll_once()
        return 200, {
            "reloaded": gen is not None,
            "generation": self._fleet_store.generation,
            "fleet_step": self._fleet_store.step,
            "degraded": self.watcher.degraded,
        }

    def _note_rollout(self, generation: int, step: int) -> None:
        with self._counters_lock:
            self._rolling_reloads += 1
        print(f"[fleet] rolling reload complete: step {step} (generation {generation})", flush=True)

    def _rollout_to(self, step_dir: Any) -> int:
        """The CommitWatcher ``load_params`` hook: roll ``step_dir`` out
        replica by replica.  Raises on the FIRST failure — remaining
        replicas are never touched, old params keep serving everywhere,
        and the watcher's breaker/quarantine handles the poison."""
        from sheeprl_tpu_torch.checkpoint.protocol import checkpoint_step

        step = checkpoint_step(step_dir)
        try:
            for rep in self.replica_list():
                if not rep.probed:
                    # dead/respawning slot: the supervisor's respawn loads
                    # the newest commit on its own, skip it here
                    continue
                rep.draining = True
                try:
                    deadline = time.monotonic() + self.drain_timeout_s
                    while rep.inflight > 0:
                        if time.monotonic() >= deadline:
                            raise TimeoutError(
                                f"replica {rep.rid} still has {rep.inflight} in-flight "
                                f"requests after {self.drain_timeout_s}s drain"
                            )
                        time.sleep(0.02)
                    status, payload = self._forward(
                        rep,
                        "POST",
                        "/v1/reload",
                        b"{}",
                        timeout=max(self.request_timeout_s, 120.0),
                    )
                    if status != 200:
                        raise IOError(f"replica {rep.rid} reload answered {status}: {payload}")
                    if int(payload.get("checkpoint_step", -1)) != step:
                        raise IOError(
                            f"replica {rep.rid} is at step {payload.get('checkpoint_step')} "
                            f"after reload, wanted {step} (its own reload breaker likely "
                            "opened — see its /healthz)"
                        )
                finally:
                    rep.draining = False
                with self._counters_lock:
                    self._replicas_reloaded += 1
        except Exception as e:
            with self._counters_lock:
                self._reload_halts += 1
            print(f"[fleet] rolling reload of step {step} halted: {type(e).__name__}: {e}", flush=True)
            raise
        return step

    # -- observability ---------------------------------------------------------
    def health(self) -> Dict[str, Any]:
        reps = self.replica_list()
        healthy = sum(1 for r in reps if r.routable)
        out: Dict[str, Any] = {
            "ok": healthy > 0,
            "fleet": True,
            "replicas": len(reps),
            "healthy": healthy,
            "draining": sum(1 for r in reps if r.draining),
            "stateful": self.stateful,
            "degraded": self.watcher.degraded if self.watcher is not None else False,
            "reload_breaker": (
                self.watcher.breaker.snapshot() if self.watcher is not None else None
            ),
            "fleet_step": (
                self._fleet_store.step
                if self.watcher is not None
                else max([r.checkpoint_step for r in reps if r.probed], default=-1)
            ),
            "per_replica": {r.rid: r.describe() for r in reps},
        }
        if self._spec is not None:
            # the single-server /healthz contract (obs_spec, action_shape,
            # algo): clients talk to the fleet exactly like one server
            out.update(self._spec)
        return out

    def stats(self) -> Dict[str, Any]:
        with self._counters_lock:
            counters = {
                "routed": self._routed,
                "failovers": self._failovers,
                "unroutable": self._unroutable,
                "ejects": self._ejects,
                "readmits": self._readmits,
                "migrations": self._migrations,
                "rolling_reloads": self._rolling_reloads,
                "reload_halts": self._reload_halts,
                "replicas_reloaded": self._replicas_reloaded,
                "respawns": self._respawns,
            }
        with self._sessions_lock:
            sessions = len(self._sessions)
        out = dict(self.health())
        out.pop("per_replica", None)
        out.update(counters)
        out["sessions"] = sessions
        out["per_replica"] = {r.rid: r.describe() for r in self.replica_list()}
        return out

    def hub_metrics(self) -> Dict[str, float]:
        """``Fleet/*`` telemetry-hub family (registered on :meth:`start`,
        exported on the router's ``/metrics`` like every other source)."""
        s = self.stats()
        metrics: Dict[str, float] = {}
        for key in (
            "replicas", "healthy", "draining", "routed", "failovers",
            "unroutable", "ejects", "readmits", "migrations", "sessions",
            "rolling_reloads", "reload_halts", "replicas_reloaded",
            "respawns", "fleet_step",
        ):
            value = s.get(key)
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                metrics[f"Fleet/{key}"] = float(value)
        metrics["Fleet/degraded"] = 1.0 if s.get("degraded") else 0.0
        return metrics


class _Deployed:
    """The fleet's "parameters" for its :class:`CommitWatcher`: the step a
    finished rollout put on every replica.  Installing it copies nothing,
    the replicas have installed the snapshot themselves."""

    def __init__(self, step: int):
        self.step = step

    def copy_into_live(self) -> None:
        pass


class FleetServer:
    """Stdlib HTTP front over a :class:`FleetRouter` — the one address
    clients see.  Speaks the same protocol as ``serve/server.py``, so
    :class:`~sheeprl_tpu_torch.serve.client.PolicyClient` points at a fleet
    unchanged."""

    def __init__(self, router: FleetRouter, host: str = "127.0.0.1", port: int = 0):
        from http.server import ThreadingHTTPServer

        class _FrontHTTPServer(ThreadingHTTPServer):
            # the fleet front absorbs every client's connection-per-request
            # burst; the stdlib default backlog of 5 RSTs connections under
            # concurrent load
            request_queue_size = 128

        self.router = router
        self._httpd = _FrontHTTPServer((host, port), _make_handler(router))
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "FleetServer":
        self.router.start()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="sheeprl-fleet-http", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(5.0)
        self.router.stop()

    def __enter__(self) -> "FleetServer":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    def serve_forever(self) -> None:
        """Foreground loop for the CLI entry (Ctrl-C → clean shutdown)."""
        self.router.start()
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self._httpd.server_close()
            self.router.stop()


def _make_handler(router: FleetRouter):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt: str, *args: Any) -> None:  # quiet by default
            pass

        def _reply(self, code: int, payload: Dict[str, Any]) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_raw(self) -> bytes:
            length = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(length) if length > 0 else b""

        def do_GET(self) -> None:  # noqa: N802 (stdlib naming)
            try:
                fault_point("serve.router")
                if self.path == "/healthz":
                    body = router.health()
                    self._reply(200 if body["ok"] else 503, body)
                elif self.path == "/v1/stats":
                    self._reply(200, router.stats())
                elif self.path == "/metrics":
                    from sheeprl_tpu_torch.telemetry import HUB, PROMETHEUS_CONTENT_TYPE, prometheus_text

                    body = prometheus_text(HUB.collect()).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", PROMETHEUS_CONTENT_TYPE)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})
            except BrokenPipeError:
                pass
            except Exception as e:
                self._safe_error(500, e)

        def do_POST(self) -> None:  # noqa: N802
            try:
                if self.path == "/v1/act":
                    code, payload = router.act(self._read_raw())
                elif self.path == "/v1/reset":
                    fault_point("serve.router")
                    body = json.loads(self._read_raw() or b"{}")
                    code, payload = router.reset(str(body.get("session", "")))
                elif self.path == "/v1/reload":
                    code, payload = router.reload_once()
                else:
                    code, payload = 404, {"error": f"unknown path {self.path}"}
                self._reply(code, payload)
            except BrokenPipeError:
                pass
            except Exception as e:
                self._safe_error(500, e)

        def _safe_error(self, code: int, e: Exception) -> None:
            try:
                self._reply(code, {"error": f"{type(e).__name__}: {e}"})
            except Exception:
                pass

    return Handler
