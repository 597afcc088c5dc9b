"""Local replica supervisor: spawn N policy servers, respawn the dead
(counterpart of ``sheeprl_tpu/serve/fleet/replicas.py``).

The process-management half of the fleet: each replica slot
(``r0``..``rN-1``) runs one ``python -m sheeprl_tpu_torch.serve`` child on
an ephemeral port with commit watching OFF (the router owns rollout
ordering — a replica that watched commits itself would break the
drain-one-at-a-time contract).  A monitor
thread notices dead children, tells the router to stop routing to the slot
immediately (:meth:`FleetRouter.mark_dead`), and respawns with jittered
exponential backoff under a fleet-lifetime budget; the respawned process
keeps the SLOT id (stable rendezvous assignments) at whatever new address
it binds.

A respawned replica re-resolves ``checkpoint_path`` itself — pass a
run/version directory (→ newest committed snapshot), not a pinned
``step_*`` dir, or respawns will come back serving stale params after a
rolling reload.

A replica runs where its config puts it (``fabric.accelerator``); with
``device`` given, a child that reports any other device when it binds
(the ``(<device>)`` of its serving line) is a failed start, never a
replica on the CPU.
"""

from __future__ import annotations

import os
import random
import re
import signal
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

#: the line ``sheeprl_tpu_torch.cli:serve`` prints once its socket is bound:
#: ``serving <algo> (checkpoint step <n>) on <url> (<device>) — batch ladder [...]``
_URL_RE = re.compile(r" on (http://[\d.]+:\d+) \(([^)]*)\)")


class _Slot:
    """One replica slot: a stable id over a sequence of child processes."""

    def __init__(self, index: int):
        self.index = index
        self.rid = f"r{index}"
        self.proc: Optional[subprocess.Popen] = None
        self.url: Optional[str] = None
        self.device: Optional[str] = None
        self.url_event = threading.Event()
        self.respawns = 0


class LocalFleet:
    """Spawn/supervise N local serve processes for a :class:`FleetRouter`.

    ``checkpoint_path`` plus ``overrides`` become each child's CLI
    arguments; ``serve.port=0`` and ``serve.watch_commits=false`` are
    appended last (they must win).  ``device`` (a device type, ``cuda`` or
    ``cpu``) is the one every child must report.  ``child_cmd`` /
    ``child_env`` exist for tests (swap the interpreter invocation, set the
    environment).
    """

    def __init__(
        self,
        checkpoint_path: str,
        overrides: Sequence[str] = (),
        replicas: int = 2,
        respawn_max: int = 10,
        backoff_base_s: float = 0.5,
        backoff_max_s: float = 30.0,
        spawn_timeout_s: float = 600.0,
        child_cmd: Optional[Callable[[List[str]], List[str]]] = None,
        child_env: Optional[Dict[str, str]] = None,
        seed: int = 0,
        echo: bool = True,
        device: Optional[str] = None,
    ):
        self.checkpoint_path = str(checkpoint_path)
        self.overrides = [a for a in overrides if not a.startswith("checkpoint_path=")]
        self.n = max(1, int(replicas))
        self.respawn_max = int(respawn_max)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.spawn_timeout_s = float(spawn_timeout_s)
        self._child_cmd = child_cmd or (
            lambda argv: [sys.executable, "-m", "sheeprl_tpu_torch.serve", *argv]
        )
        self.device = device
        self._child_env = dict(child_env) if child_env else None
        self._rng = random.Random(int(seed) or None)
        self._echo = bool(echo)
        self._slots = [_Slot(i) for i in range(self.n)]
        self._router: Optional[Any] = None
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self.respawns_used = 0

    # -- spawning --------------------------------------------------------------
    def _child_argv(self) -> List[str]:
        return [
            f"checkpoint_path={self.checkpoint_path}",
            *self.overrides,
            # appended LAST so they win: every replica on its own ephemeral
            # port, commit watch off (the router's rolling reload is the
            # only thing allowed to move a replica's params)
            "serve.port=0",
            "serve.watch_commits=false",
        ]

    def _spawn(self, slot: _Slot) -> None:
        env = None
        if self._child_env is not None:
            env = {**os.environ, **self._child_env}
        slot.url = slot.device = None
        slot.url_event.clear()
        proc = subprocess.Popen(
            self._child_cmd(self._child_argv()),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        slot.proc = proc

        def drain() -> None:
            try:
                for line in proc.stdout:  # type: ignore[union-attr]
                    if self._echo:
                        sys.stdout.write(f"[{slot.rid}] {line}")
                        sys.stdout.flush()
                    if slot.url is None:
                        m = _URL_RE.search(line)
                        if m:
                            slot.url, slot.device = m.group(1), m.group(2)
                            slot.url_event.set()
            except (ValueError, OSError):
                pass  # pipe closed under us during kill

        threading.Thread(target=drain, name=f"fleet-stdout-{slot.rid}", daemon=True).start()

    def _wait_url(self, slot: _Slot, timeout: float) -> Optional[str]:
        """The child's URL once it has bound; None when it died first or
        bound on another device than ``device`` (then it is killed)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and not self._stop.is_set():
            if slot.url_event.wait(0.5):
                if self.device is not None and slot.device.split(":")[0] != self.device:
                    print(f"[fleet] replica {slot.rid} came up on {slot.device}, not {self.device}: killed",
                          flush=True)
                    self.kill(slot.index)
                    return None
                return slot.url
            if slot.proc is not None and slot.proc.poll() is not None:
                return None  # died before binding
        return None

    def start(self) -> "LocalFleet":
        """Spawn every slot and block until each has printed its URL.
        Children warm their batch ladders concurrently — the slowest one
        bounds startup, not the sum."""
        for slot in self._slots:
            self._spawn(slot)
        for slot in self._slots:
            if self._wait_url(slot, self.spawn_timeout_s) is None:
                self.stop()
                raise RuntimeError(
                    f"replica {slot.rid} failed to start within {self.spawn_timeout_s}s"
                )
        return self

    def addresses(self) -> Dict[str, str]:
        return {slot.rid: slot.url for slot in self._slots if slot.url}

    # -- supervision -----------------------------------------------------------
    def attach(self, router: Any) -> None:
        """Wire the respawn loop to a router and start monitoring."""
        self._router = router
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="fleet-monitor", daemon=True
        )
        self._monitor.start()

    def _backoff_s(self, slot: _Slot) -> float:
        base = min(
            self.backoff_max_s,
            self.backoff_base_s * (2.0 ** max(0, slot.respawns - 1)),
        )
        return base * self._rng.uniform(0.5, 1.5)

    def _monitor_loop(self) -> None:
        while not self._stop.wait(0.5):
            for slot in self._slots:
                proc = slot.proc
                if proc is None or proc.poll() is None:
                    continue
                rc = proc.returncode
                if self._router is not None:
                    self._router.mark_dead(slot.rid)
                if self.respawns_used >= self.respawn_max:
                    print(
                        f"[fleet] replica {slot.rid} died (rc={rc}) — respawn budget "
                        f"exhausted ({self.respawn_max}), slot stays down",
                        flush=True,
                    )
                    slot.proc = None
                    continue
                self.respawns_used += 1
                slot.respawns += 1
                delay = self._backoff_s(slot)
                print(
                    f"[fleet] replica {slot.rid} died (rc={rc}) — respawning in "
                    f"{delay:.1f}s ({self.respawns_used}/{self.respawn_max})",
                    flush=True,
                )
                if self._stop.wait(delay):
                    return
                self._spawn(slot)
                url = self._wait_url(slot, self.spawn_timeout_s)
                if url is None:
                    # died again before binding: next loop pass classifies it
                    continue
                if self._router is not None:
                    self._router.replace_replica(slot.rid, url)
                    self._router.note_respawn()
                print(f"[fleet] replica {slot.rid} back at {url}", flush=True)

    # -- chaos / teardown ------------------------------------------------------
    def kill(self, index: int, sig: int = signal.SIGKILL) -> None:
        """Kill one replica process (the chaos drill's hammer).  The
        monitor notices and runs the ordinary respawn path — that's the
        point: a drill kill and a real crash share every line of code."""
        slot = self._slots[index]
        if slot.proc is not None and slot.proc.poll() is None:
            slot.proc.send_signal(sig)

    def stop(self, timeout: float = 15.0) -> None:
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=2.0)
        for slot in self._slots:
            proc = slot.proc
            if proc is None or proc.poll() is not None:
                continue
            try:
                proc.send_signal(signal.SIGINT)  # serve_forever's clean path
            except OSError:
                continue
        deadline = time.monotonic() + timeout
        for slot in self._slots:
            proc = slot.proc
            if proc is None:
                continue
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                try:
                    proc.kill()
                    proc.wait(timeout=5.0)
                except (OSError, subprocess.TimeoutExpired):
                    pass

    def __enter__(self) -> "LocalFleet":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()
