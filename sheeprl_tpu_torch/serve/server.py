"""Stdlib HTTP surface over :class:`~sheeprl_tpu_torch.serve.service.PolicyService`
(counterpart of ``sheeprl_tpu/serve/server.py``).

One ``ThreadingHTTPServer`` per served model: every connection handler
thread submits into the service's admission queue and blocks on its request,
so the continuous batcher coalesces across HTTP connections.

Endpoints (all JSON):

* ``POST /v1/act``   — ``{"obs": {...}, "greedy"?: bool, "session"?: str}``
  → ``{"action": [...], "shape": [...], "dtype": "...", "generation": n}``
* ``POST /v1/reset`` — ``{"session": str}`` drops a stateful episode carry
* ``POST /v1/reload`` — one synchronous commit check (install a newer
  committed snapshot now) → ``{"reloaded": bool, "generation": n, ...}``
* ``GET  /v1/session_carry?session=<id>`` — that session's CRC-stamped carry
  snapshot; ``POST /v1/session_carry`` ``{"session", "snapshot"}`` installs
  one (400 when it fails its checks)
* ``GET  /v1/stats`` — the service's stats dict
* ``GET  /metrics``  — every telemetry-hub metric (``Serve/*`` included) in
  Prometheus text exposition format
* ``GET  /healthz``  — liveness + model identity; ``degraded: true`` while the
  reload breaker is open (new commits fail to load, the old parameters serve)

Arrays travel as nested JSON lists or as packed
``{"__nd__": {"b64": ..., "shape": [...], "dtype": "..."}}`` blobs.
"""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from sheeprl_tpu_torch.resilience.faults import fault_point
from sheeprl_tpu_torch.serve.batcher import QueueFull, ServiceStopped


def decode_array(value: Any, dtype: Optional[str] = None) -> np.ndarray:
    """JSON value → ndarray: nested lists, or a packed ``__nd__`` blob."""
    if isinstance(value, dict) and "__nd__" in value:
        nd = value["__nd__"]
        buf = base64.b64decode(nd["b64"])
        return np.frombuffer(buf, dtype=np.dtype(nd["dtype"])).reshape(nd["shape"]).copy()
    arr = np.asarray(value)
    if dtype is not None:
        arr = arr.astype(np.dtype(dtype), copy=False)
    return arr


def encode_array(arr: np.ndarray, packed: bool = False) -> Any:
    """ndarray → JSON value (packed base64 blob or nested lists)."""
    arr = np.asarray(arr)
    if packed:
        return {
            "__nd__": {
                "b64": base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode("ascii"),
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
            }
        }
    return arr.tolist()


class PolicyServer:
    """HTTP wrapper owning a :class:`PolicyService`.  ``port=0`` binds an
    ephemeral port; :attr:`address` is the bound ``(host, port)``."""

    def __init__(self, service: Any, host: str = "127.0.0.1", port: int = 0):
        class _HTTPServer(ThreadingHTTPServer):
            request_queue_size = 128  # the stdlib backlog of 5 resets connections under load

        self.service = service
        self._httpd = _HTTPServer((host, port), _make_handler(service))
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "PolicyServer":
        self.service.start()
        self._thread = threading.Thread(target=self._httpd.serve_forever, name="sheeprl-serve-http", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(5.0)
        self.service.stop()

    def __enter__(self) -> "PolicyServer":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    def serve_forever(self) -> None:
        """Foreground loop for the CLI entry (Ctrl-C → clean shutdown)."""
        self.service.start()
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self._httpd.server_close()
            self.service.stop()


def _make_handler(service: Any):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt: str, *args: Any) -> None:
            pass

        def _reply(self, code: int, payload: Dict[str, Any]) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_json(self) -> Dict[str, Any]:
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0:
                return {}
            return json.loads(self.rfile.read(length) or b"{}")

        def do_GET(self) -> None:  # noqa: N802 (stdlib naming)
            try:
                # fault site: raise → 500 (the client retries an idempotent
                # request), hang/latency → a slow or stuck reply
                fault_point("serve.http")
                if self.path == "/healthz":
                    player = service.player
                    watcher = service.watcher
                    self._reply(
                        200,
                        {
                            "ok": True,
                            # liveness over freshness: the old parameters serve
                            "degraded": watcher.degraded if watcher else False,
                            "reload_breaker": watcher.breaker.snapshot() if watcher else None,
                            "algo": player.algo,
                            "device": str(player.device),
                            "checkpoint_step": service.store.step,
                            "generation": service.store.generation,
                            "obs_spec": {k: [list(shape), dt] for k, (shape, dt) in player.obs_spec.items()},
                            "action_shape": list(player.action_shape),
                            "stateful": player.stateful,
                        },
                    )
                elif self.path == "/v1/stats":
                    self._reply(200, service.stats())
                elif self.path.startswith("/v1/session_carry"):
                    session = (parse_qs(urlparse(self.path).query).get("session") or [""])[0]
                    if not session:
                        self._reply(400, {"error": "session_carry requires ?session=<id>"})
                    else:
                        self._reply(200, {"session": session, "snapshot": service.get_session_carry(session)})
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
                fault_point("serve.http")
                if self.path == "/v1/act":
                    self._act()
                elif self.path == "/v1/reset":
                    body = self._read_json()
                    service.reset_session(str(body.get("session", "")))
                    self._reply(200, {"ok": True})
                elif self.path == "/v1/reload":
                    gen = service.watcher.poll_once() if service.watcher else None
                    self._reply(200, {"reloaded": gen is not None, "generation": service.store.generation,
                                      "checkpoint_step": service.store.step})
                elif self.path == "/v1/session_carry":
                    body = self._read_json()
                    session = str(body.get("session", ""))
                    snapshot = body.get("snapshot")
                    if not session or not isinstance(snapshot, dict):
                        self._reply(400, {"error": "session_carry requires 'session' and 'snapshot'"})
                        return
                    try:
                        service.restore_session_carry(session, snapshot)
                    except ValueError as e:
                        self._reply(400, {"error": str(e)})
                        return
                    self._reply(200, {"ok": True, "session": session})
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})
            except BrokenPipeError:
                pass
            except Exception as e:
                self._safe_error(500, e)

        def _act(self) -> None:
            body = self._read_json()
            raw = body.get("obs")
            if not isinstance(raw, dict):
                self._reply(400, {"error": "body must carry an 'obs' dict"})
                return
            spec = service.player.obs_spec
            missing = sorted(set(spec) - set(raw))
            if missing:
                self._reply(400, {"error": f"missing obs keys: {missing}"})
                return
            obs = {k: decode_array(raw[k], dtype=spec[k][1]) for k in spec}
            try:
                action = service.act(
                    obs,
                    greedy=body.get("greedy"),
                    session=body.get("session"),
                    timeout=float(body.get("timeout", 30.0)),
                    block=False,  # full queue → 429 now, not a pinned thread
                )
            except QueueFull as e:
                self._reply(429, {"error": str(e)})
                return
            except ServiceStopped as e:
                self._reply(503, {"error": str(e)})
                return
            except TimeoutError as e:
                self._reply(504, {"error": str(e)})
                return
            action = np.asarray(action)
            payload = {
                "action": encode_array(action, packed=bool(body.get("packed"))),
                "shape": list(action.shape),
                "dtype": str(action.dtype),
                "generation": service.store.generation,
                "checkpoint_step": service.store.step,
            }
            session = body.get("session")
            if body.get("return_carry") and session is not None:
                # the post-step carry rides the act response
                payload["carry"] = service.get_session_carry(str(session))
            self._reply(200, payload)

        def _safe_error(self, code: int, e: Exception) -> None:
            try:
                self._reply(code, {"error": f"{type(e).__name__}: {e}"})
            except OSError:
                pass

    return Handler
