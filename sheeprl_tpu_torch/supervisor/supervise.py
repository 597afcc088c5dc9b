"""The self-healing run supervisor (counterpart of
``sheeprl_tpu/supervisor/supervise.py``), for one child process on one
device: ``python -m sheeprl_tpu_torch.supervisor <overrides>`` or
``python -m sheeprl_tpu_torch supervise <overrides>``.

Launches a training invocation of the port (``python -m sheeprl_tpu_torch
<overrides>``) as a child process and keeps it alive the way an external
operator would — but with the judgment the run's telemetry gives it:

* **heartbeat**: the child is forced to arm its introspection endpoint
  (``telemetry.introspect.port=0``; the URL is parsed off its stdout) and
  ``/healthz`` is polled — an unreachable endpoint past a grace window,
  or a ``stalled: true`` (HTTP 503, update-free past
  ``telemetry.stall_after_s``) answer that persists, gets the child
  killed (SIGTERM first: the preemption latch turns that into a final
  committed save) and restarted;
* **classification** (``classify.py``): every exit is triaged on the exit
  status + the run's ``postmortem.json``.  Transient failures (signals,
  hangs, first-occurrence crashes, preemptions, missing postmortems)
  restart under a budget with jittered exponential backoff and
  ``checkpoint.resume_from=auto`` — the run continues from its last
  committed snapshot.  The SAME fatal signature ``(error, last_step)``
  twice in a row opens the **crash-loop circuit breaker**: the supervisor
  stops, exits nonzero, and surfaces the postmortem reason instead of
  looping;
* **audit**: every episode appends one JSON line to
  ``<log_dir>/<root_dir>/supervisor_log.jsonl`` — when the run finally
  needs a human, the whole restart history is one file.

Exit codes: ``0`` the run completed; ``2`` the circuit breaker opened
(deterministic failure — the postmortem reason is printed); ``3`` the
restart budget is exhausted; the child's own code when the supervisor
itself was told to stop (SIGTERM/SIGINT are forwarded to the child).

Configured by the ``supervisor.*`` config group.  A pod-shaped invocation
(several processes) raises: the pod supervisor comes with the layer above
one device (ROADMAP.md, queue A item 5(b)).
"""

from __future__ import annotations

import glob
import json
import os
import random
import re
import signal
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from sheeprl_tpu_torch.config.compose import ConfigError
from sheeprl_tpu_torch.supervisor.classify import (
    DETERMINISTIC,
    SUCCESS,
    Verdict,
    classify,
    load_postmortem,
)

_URL_RE = re.compile(r"telemetry introspection on (http://\S+)")

#: supervisor exit codes
EXIT_OK = 0
EXIT_BREAKER = 2
EXIT_BUDGET = 3


def _now_iso() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S%z")


class Supervisor:
    """One supervised run: episodes of the same child invocation."""

    def __init__(
        self,
        cfg: Any,
        argv: List[str],
        *,
        child_cmd: Optional[Callable[[List[str]], List[str]]] = None,
        child_env: Optional[Dict[str, str]] = None,
        handle_signals: bool = True,
    ):
        scfg = (cfg.get("supervisor") or {}) if hasattr(cfg, "get") else {}
        self.cfg = cfg
        self.argv = list(argv)
        self.max_restarts = int(scfg.get("max_restarts", 10))
        self.breaker_threshold = max(2, int(scfg.get("breaker_threshold", 2) or 2))
        self.backoff_base_s = float(scfg.get("backoff_base_s", 2.0))
        self.backoff_max_s = float(scfg.get("backoff_max_s", 60.0))
        self.poll_interval_s = float(scfg.get("poll_interval_s", 2.0))
        self.heartbeat_grace_s = float(scfg.get("heartbeat_grace_s", 60.0))
        self.stall_grace_s = float(scfg.get("stall_grace_s", 30.0))
        self.first_heartbeat_timeout_s = float(scfg.get("first_heartbeat_timeout_s", 0.0) or 0.0)
        self.progress_timeout_s = float(scfg.get("progress_timeout_s", 0.0) or 0.0)
        self.kill_grace_s = float(scfg.get("kill_grace_s", 30.0))
        self.introspect = bool(scfg.get("introspect", True))
        log_dir = str(cfg.get("log_dir", "logs/runs")) if hasattr(cfg, "get") else "logs/runs"
        root_dir = str(cfg.get("root_dir", "run")) if hasattr(cfg, "get") else "run"
        self.exp_root = os.path.join(log_dir, root_dir)
        self.audit_path = os.path.join(
            self.exp_root, str(scfg.get("log_name", "supervisor_log.jsonl"))
        )
        self._child_cmd = child_cmd or (
            lambda child_argv: [sys.executable, "-m", "sheeprl_tpu_torch", *child_argv]
        )
        self._child_env = dict(child_env) if child_env else None
        self._handle_signals = bool(handle_signals)
        self._rng = random.Random(int(scfg.get("seed", 0) or 0) or None)
        self._stop = threading.Event()
        self._child: Optional[subprocess.Popen] = None
        self._url: Optional[str] = None
        self._url_event = threading.Event()
        self.restarts_used = 0
        self._last_signature: Optional[tuple] = None
        self._signature_run = 0
        self.episodes: List[Dict[str, Any]] = []

    # -- signal forwarding ----------------------------------------------------
    def install_signals(self) -> None:
        """SIGTERM/SIGINT stop the SUPERVISOR: the signal is forwarded to
        the child (whose preemption latch performs a final committed save)
        and no restart follows — a preempted pod must drain, not respawn."""
        if not self._handle_signals:
            return
        if threading.current_thread() is not threading.main_thread():
            return
        def handler(signum: int, frame: Any) -> None:
            self._stop.set()
            child = self._child
            if child is not None and child.poll() is None:
                try:
                    child.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        try:
            signal.signal(signal.SIGTERM, handler)
            signal.signal(signal.SIGINT, handler)
        except (ValueError, OSError):
            pass

    # -- episode mechanics ----------------------------------------------------
    def _episode_argv(self, episode: int) -> List[str]:
        child_argv = list(self.argv)
        if self.introspect and not any(
            a.startswith("telemetry.introspect.port=") for a in child_argv
        ):
            child_argv.append("telemetry.introspect.port=0")
        if episode > 0:
            # appended LAST so it wins over any user-given resume_from: a
            # relaunch must resume from the newest committed snapshot, which
            # by now is the previous episode's, not the user's original
            child_argv.append("checkpoint.resume_from=auto")
        return child_argv

    def _spawn(self, episode: int) -> subprocess.Popen:
        cmd = self._child_cmd(self._episode_argv(episode))
        env = None
        if self._child_env is not None:
            env = {**os.environ, **self._child_env}
        self._url = None
        self._url_event.clear()
        child = subprocess.Popen(
            cmd,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        self._child = child

        def drain() -> None:
            try:
                for line in child.stdout:  # type: ignore[union-attr]
                    sys.stdout.write(line)
                    sys.stdout.flush()
                    if self._url is None:
                        m = _URL_RE.search(line)
                        if m:
                            self._url = m.group(1)
                            self._url_event.set()
            except (ValueError, OSError):
                pass  # pipe closed under us during kill

        threading.Thread(target=drain, name="supervisor-stdout", daemon=True).start()
        return child

    def _healthz(self) -> Optional[Dict[str, Any]]:
        """One ``/healthz`` probe: the parsed body (including 503 stalled
        answers), or None when unreachable."""
        if not self._url:
            return None
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(
                self._url + "/healthz", timeout=min(5.0, max(1.0, self.poll_interval_s))
            ) as resp:
                return json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            if e.code == 503:
                try:
                    return json.loads(e.read().decode())
                except Exception:
                    return {"ok": False, "stalled": True}
            return None
        except Exception:
            return None

    def _kill_child(self, child: subprocess.Popen) -> None:
        """SIGTERM (graceful: the preemption latch commits a final save),
        escalate to SIGKILL past the grace window."""
        if child.poll() is not None:
            return
        try:
            child.send_signal(signal.SIGTERM)
        except OSError:
            return
        try:
            child.wait(timeout=self.kill_grace_s)
        except subprocess.TimeoutExpired:
            try:
                child.kill()
            except OSError:
                pass
            try:
                child.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                pass

    def _watch(self, child: subprocess.Popen, started: float) -> bool:
        """Block until the child exits or the watchdog kills it.  Returns
        True when the supervisor decided the child was HUNG."""
        last_ok: Optional[float] = None
        stalled_since: Optional[float] = None
        last_updates: Optional[int] = None
        last_progress = started
        while True:
            if child.poll() is not None:
                return False
            if self._stop.is_set():
                self._kill_child(child)
                return False
            now = time.monotonic()
            hung = False
            body = self._healthz()
            if body is not None:
                if body.get("stalled"):
                    stalled_since = stalled_since or now
                    if now - stalled_since > self.stall_grace_s:
                        self._log_line(
                            f"child stalled (last_update_age_s="
                            f"{body.get('last_update_age_s')}) past the grace window"
                        )
                        hung = True
                else:
                    stalled_since = None
                    last_ok = now
                updates = body.get("updates_done")
                if isinstance(updates, int):
                    if updates != last_updates:
                        last_updates = updates
                        last_progress = now
                    elif (
                        self.progress_timeout_s > 0
                        and updates > 0
                        and now - last_progress > self.progress_timeout_s
                    ):
                        self._log_line("child made no update progress past the timeout")
                        hung = True
            else:
                if self._url is not None:
                    if last_ok is None:
                        # the URL just appeared: start the unreachable clock
                        # NOW — a child that prints its URL but whose server
                        # never answers a single probe must still be killable
                        last_ok = now
                    elif now - last_ok > self.heartbeat_grace_s:
                        self._log_line("child heartbeat unreachable past the grace window")
                        hung = True
                elif (
                    self.first_heartbeat_timeout_s > 0
                    and now - started > self.first_heartbeat_timeout_s
                ):
                    self._log_line("child never armed its introspection endpoint")
                    hung = True
            if hung:
                self._kill_child(child)
                return True
            # wait on the URL event the first time around so short-lived
            # children don't sleep a full interval before being noticed
            if not self._url_event.is_set():
                self._url_event.wait(self.poll_interval_s)
            else:
                time.sleep(self.poll_interval_s)

    def _find_postmortem(self, not_before: float) -> Optional[str]:
        """Newest postmortem.json under the experiment root written since
        ``not_before`` (each episode gets a fresh timestamped run dir, so
        mtime-filtering keeps old episodes' evidence out).  The tolerance
        is a bare float-jitter epsilon: anything generous (e.g. 1 s) would
        let a fast relaunch re-read the PREVIOUS episode's preemption
        postmortem and misclassify a clean completion as preempted."""
        newest, newest_mtime = None, not_before - 1e-3
        for path in glob.glob(
            os.path.join(glob.escape(self.exp_root), "**", "postmortem.json"), recursive=True
        ):
            try:
                mtime = os.path.getmtime(path)
            except OSError:
                continue
            if mtime > newest_mtime:
                newest, newest_mtime = path, mtime
        return newest

    # -- audit ----------------------------------------------------------------
    def _log_line(self, msg: str) -> None:
        print(f"[supervisor] {msg}", flush=True)

    def _append_audit(self, record: Dict[str, Any]) -> None:
        self.episodes.append(record)
        try:
            os.makedirs(os.path.dirname(self.audit_path), exist_ok=True)
            with open(self.audit_path, "a") as f:
                f.write(json.dumps(record, default=str) + "\n")
        except OSError as e:
            self._log_line(f"audit log write failed: {e}")

    def _backoff_s(self) -> float:
        base = min(
            self.backoff_max_s,
            self.backoff_base_s * (2.0 ** max(0, self.restarts_used - 1)),
        )
        return base * self._rng.uniform(0.5, 1.5)

    # -- the supervision loop --------------------------------------------------
    def run(self) -> int:
        self.install_signals()
        self._log_line(
            f"supervising: {' '.join(self.argv)} "
            f"(max_restarts={self.max_restarts}, breaker={self.breaker_threshold})"
        )
        episode = 0
        while True:
            started_mono = time.monotonic()
            started_wall = time.time()
            started_iso = _now_iso()
            child = self._spawn(episode)
            hung = self._watch(child, started_mono)
            returncode = child.wait()
            pm_path = self._find_postmortem(started_wall)
            postmortem = load_postmortem(pm_path)
            verdict = classify(returncode, postmortem, hung=hung)

            # crash-loop circuit breaker: the SAME fatal signature twice in
            # a row is a deterministic failure — stop and surface it
            if verdict.signature is not None and verdict.signature == self._last_signature:
                self._signature_run += 1
            else:
                self._signature_run = 1
            self._last_signature = verdict.signature
            if (
                verdict.signature is not None
                and self._signature_run >= self.breaker_threshold
            ):
                verdict = Verdict(
                    DETERMINISTIC,
                    f"circuit breaker open: identical fatal signature "
                    f"{self._signature_run}x in a row — {verdict.reason}",
                    signature=verdict.signature,
                    detail=verdict.detail,
                )

            stopping = self._stop.is_set()
            budget_left = self.max_restarts - self.restarts_used
            if verdict.kind == SUCCESS or stopping:
                action, delay = "done", 0.0
            elif verdict.kind == DETERMINISTIC:
                action, delay = "stop", 0.0
            elif budget_left <= 0:
                action, delay = "budget-exhausted", 0.0
            else:
                action = "restart"
                self.restarts_used += 1
                delay = self._backoff_s()

            record = {
                "episode": episode,
                "started_at": started_iso,
                "ended_at": _now_iso(),
                "wall_s": round(time.monotonic() - started_mono, 3),
                "returncode": returncode,
                "hung": hung,
                "classification": verdict.kind,
                "reason": verdict.reason,
                "signature": list(verdict.signature) if verdict.signature else None,
                "signature_run": self._signature_run,
                "postmortem": pm_path,
                "action": action,
                "next_delay_s": round(delay, 3),
                "restarts_used": self.restarts_used,
                **({"detail": verdict.detail} if verdict.detail else {}),
            }
            self._append_audit(record)
            self._log_line(
                f"episode {episode}: rc={returncode} hung={hung} -> "
                f"{verdict.kind} ({verdict.reason}); action={action}"
            )

            if verdict.kind == SUCCESS:
                return EXIT_OK
            if stopping:
                self._log_line("stop requested — not restarting")
                # only a sane positive child code passes through: a
                # signal-killed child reports a NEGATIVE returncode, and
                # sys.exit(-15) would surface as shell status 241 —
                # indistinguishable from a crash to scripts keying on the
                # documented 0/2/3 codes
                return returncode if returncode and returncode > 0 else EXIT_OK
            if verdict.kind == DETERMINISTIC:
                reason = (postmortem or {}).get("reason") if postmortem else None
                err = verdict.signature[0] if verdict.signature else verdict.reason
                self._log_line(
                    f"giving up: deterministic failure (postmortem reason="
                    f"{reason!r}): {err}"
                )
                return EXIT_BREAKER
            if action == "budget-exhausted":
                self._log_line(
                    f"giving up: restart budget exhausted "
                    f"(supervisor.max_restarts={self.max_restarts})"
                )
                return EXIT_BUDGET

            self._log_line(
                f"restarting (attempt {self.restarts_used}/{self.max_restarts}) "
                f"in {delay:.1f}s with checkpoint.resume_from=auto"
            )
            if self._stop.wait(delay):
                self._log_line("stop requested during backoff — not restarting")
                return EXIT_OK
            episode += 1


#: the launcher-mode variable of a fake multi-host run (JAX's ``SHEEPRL_FAKE_DCN``)
ENV_FAKE = "SHEEPRL_FAKE_DCN"


def resolve_supervisor(cfg: Any, argv: List[str], **kwargs: Any) -> Supervisor:
    """The launch-time routing: a pod-shaped invocation (``SHEEPRL_FAKE_DCN``
    set above 1, or ``fabric.distributed.num_processes`` configured above 1)
    raises, since the port's pod supervisor comes with the layer above one
    device; everything else gets the plain :class:`Supervisor`."""
    num = int(os.environ.get(ENV_FAKE, 0) or 0)
    if num <= 1:
        fabric = cfg.get("fabric") if hasattr(cfg, "get") else None
        group = (fabric.get("distributed") if fabric is not None else None) or {}
        num = int(group.get("num_processes") or 0)
    if num > 1:
        raise ConfigError(
            f"a pod-shaped supervised run ({num} processes) is not ported: the pod supervisor comes with the "
            "layer above one device (ROADMAP.md, queue A item 5(b))")
    return Supervisor(cfg, argv, **kwargs)


def main(argv: Optional[List[str]] = None) -> None:
    """``python -m sheeprl_tpu_torch.supervisor <the overrides you would pass
    to python -m sheeprl_tpu_torch>``: composes the config once (for the
    ``supervisor.*`` and path knobs), then supervises the child invocation."""
    argv = list(sys.argv[1:] if argv is None else argv)
    from sheeprl_tpu_torch.config.compose import compose

    cfg = compose(argv)
    sys.exit(resolve_supervisor(cfg, argv).run())
