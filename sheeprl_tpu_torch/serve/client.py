"""Stdlib client for the ``sheeprl_tpu_torch.serve`` HTTP surface
(counterpart of ``sheeprl_tpu/serve/client.py``).

Every non-2xx answer raises :class:`ServeRequestError` with the status and
the server's error.  Connection errors and 5xx answers to idempotent
requests are retried with exponential backoff; ``act`` with a ``session``
is not idempotent (it advances the server-side carry), except on 503,
which certifies the request was never dispatched.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Any, Dict, Optional

import numpy as np

from sheeprl_tpu_torch.serve.server import decode_array, encode_array

_BODY_TRUNCATE = 512


class ServeRequestError(RuntimeError):
    """Non-2xx response from the policy server."""

    def __init__(self, status: int, body: str):
        super().__init__(f"HTTP {status}: {body}")
        self.status = int(status)
        self.body = body


class PolicyClient:
    def __init__(
        self,
        base_url: str,
        timeout: float = 30.0,
        packed: bool = False,
        retries: int = 3,
        retry_base_s: float = 0.2,
    ):
        """``packed=True`` ships arrays as base64 blobs (cheap for images).
        ``retries`` bounds the attempts of a retriable request (1 = once)."""
        self.base_url = base_url.rstrip("/")
        self.timeout = float(timeout)
        self.packed = bool(packed)
        self.retries = max(1, int(retries))
        self.retry_base_s = float(retry_base_s)

    def _call_once(self, method: str, path: str, body: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            self.base_url + path, data=data, method=method, headers={"Content-Type": "application/json"}
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            raw = e.read() or b""
            try:
                message = json.loads(raw)["error"]
            except (ValueError, KeyError, TypeError):
                message = raw.decode("utf-8", "replace")[:_BODY_TRUNCATE] or str(e)
            raise ServeRequestError(e.code, message) from None

    def _call(self, method: str, path: str, body: Optional[Dict[str, Any]] = None, idempotent: bool = True):
        def transient(e: BaseException) -> bool:
            if isinstance(e, ServeRequestError):
                return e.status == 503 or (idempotent and e.status >= 500)
            if isinstance(e, urllib.error.URLError):
                return idempotent or isinstance(e.reason, ConnectionRefusedError)
            return idempotent

        for attempt in range(self.retries):
            try:
                return self._call_once(method, path, body)
            except (ServeRequestError, urllib.error.URLError, ConnectionError, TimeoutError) as e:
                if attempt == self.retries - 1 or not transient(e):
                    raise
                time.sleep(min(5.0, self.retry_base_s * 2**attempt))

    def act(
        self,
        obs: Dict[str, np.ndarray],
        greedy: Optional[bool] = None,
        session: Optional[str] = None,
        timeout: Optional[float] = None,
    ) -> np.ndarray:
        body: Dict[str, Any] = {
            "obs": {k: encode_array(np.asarray(v), packed=self.packed) for k, v in obs.items()},
            "packed": self.packed,
        }
        if greedy is not None:
            body["greedy"] = bool(greedy)
        if session is not None:
            body["session"] = session
        if timeout is not None:
            body["timeout"] = float(timeout)
        out = self._call("POST", "/v1/act", body, idempotent=session is None)
        action = decode_array(out["action"], dtype=out.get("dtype"))
        return np.asarray(action).reshape(out.get("shape", np.asarray(action).shape))

    def reset(self, session: str) -> None:
        self._call("POST", "/v1/reset", {"session": session})

    def reload(self) -> Dict[str, Any]:
        """Force one commit-watch poll on the server."""
        return self._call("POST", "/v1/reload", {})

    def session_carry(self, session: str) -> Optional[Dict[str, Any]]:
        """A session's CRC-stamped carry snapshot (None when the server has no
        carry for it or the player is stateless)."""
        from urllib.parse import quote

        return self._call("GET", f"/v1/session_carry?session={quote(session, safe='')}").get("snapshot")

    def restore_session_carry(self, session: str, snapshot: Dict[str, Any]) -> Dict[str, Any]:
        """Install a carry snapshot under ``session``; not idempotent, as an act."""
        return self._call("POST", "/v1/session_carry", {"session": session, "snapshot": snapshot}, idempotent=False)

    def stats(self) -> Dict[str, Any]:
        return self._call("GET", "/v1/stats")

    def health(self) -> Dict[str, Any]:
        return self._call("GET", "/healthz")
