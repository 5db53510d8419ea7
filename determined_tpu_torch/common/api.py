"""Minimal HTTP client for the master REST API.

The port's copy of determined_tpu/common/api.py (stdlib only): `Session`
with `get`, `post`, `patch`, `delete` and `login`, the same retry policy,
TLS pinning, idempotency keys and the extra `headers` every request
carries (managed mode's `X-Allocation-Epoch` fence). A serve replica and
a managed trial (`core.init()`) both speak through it.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import os
import random
import socket
import ssl
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid
from typing import Any, Dict, Optional


def _https_context() -> Optional[ssl.SSLContext]:
    """TLS context for https:// masters. DET_MASTER_CERT_FILE pins the CA
    bundle the server chain must anchor in (reference
    common/api/certs.py); unset = system roots. Self-signed deploy certs
    are their own CA, so hostname checking is off and trust comes from
    the pinned bundle — exactly the reference's cert-pinning posture."""
    cert_file = os.environ.get("DET_MASTER_CERT_FILE", "")
    if cert_file:
        ctx = ssl.create_default_context(cafile=cert_file)
        ctx.check_hostname = False
        return ctx
    return ssl.create_default_context()


def salted_hash(username: str, password: str) -> str:
    """Client-side salted password hash, as the master stores it: raw
    passwords never reach the wire. An empty password maps to ""."""
    if not password:
        return ""
    salted = f"determined-tpu${username}${password}".encode()
    return hashlib.sha256(salted).hexdigest()


class APIError(Exception):
    def __init__(self, status: int, body: str, url: str):
        super().__init__(f"HTTP {status} from {url}: {body[:500]}")
        self.status = status
        self.body = body
        self.url = url


class Session:
    """Authenticated master session with retry on transient failures.

    Retry policy (chaos-hardened, see docs/chaos.md):
      - capped exponential backoff with FULL jitter between attempts
        (sleep ~ U(0, min(cap, base * 2**attempt)));
      - a `Retry-After: <seconds>` response header sets the floor for the
        next sleep; 429 is always retried;
      - 502/503/504 are retried for every method (gateway-transient);
        500 and other 5xx are retried only when the request is safe to
        repeat — GETs, and POSTs carrying an idempotency key;
      - POSTs sent with `idempotent=True` get an `X-Idempotency-Key`
        header, generated once per logical request, so the master can
        answer a retry from its replay cache instead of re-applying the
        mutation (a re-sent metric report cannot double-count).
    """

    def __init__(
        self,
        master_url: str,
        token: Optional[str] = None,
        max_retries: int = 8,
        timeout: float = 30.0,
        backoff_base: float = 0.1,
        backoff_cap: float = 5.0,
        headers: Optional[Dict[str, str]] = None,
    ):
        self.master_url = master_url.rstrip("/")
        self.token = token
        self.max_retries = max_retries
        self.timeout = timeout
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        # Extra headers sent with every request — the allocation context
        # installs X-Allocation-Epoch here so every state-mutating call
        # carries the fencing token (docs/cluster-ops.md "Leases, fencing
        # & split-brain").
        self.headers = dict(headers) if headers else {}
        self._ssl_ctx = (
            _https_context() if self.master_url.startswith("https://") else None
        )

    def _backoff(self, attempt: int, retry_after: Optional[float]) -> None:
        delay = random.uniform(
            0.0, min(self.backoff_cap, self.backoff_base * (2.0 ** attempt))
        )
        if retry_after is not None:
            delay = max(delay, retry_after)
        time.sleep(delay)

    @classmethod
    def login(cls, master_url: str, user: str = "determined",
              password: str = "") -> "Session":
        s = cls(master_url)
        resp = s.post("/api/v1/auth/login",
                      body={"username": user,
                            "password": salted_hash(user, password)})
        s.token = resp["token"]
        return s

    def _request(
        self,
        method: str,
        path: str,
        body: Optional[Dict[str, Any]] = None,
        params: Optional[Dict[str, Any]] = None,
        timeout: Optional[float] = None,
        idempotent: bool = False,
    ) -> Any:
        url = self.master_url + path
        if params:
            url += "?" + urllib.parse.urlencode(
                {k: v for k, v in params.items() if v is not None}
            )
        data = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"}
        headers.update(self.headers)
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        if idempotent and method not in ("GET", "HEAD"):
            # One key per LOGICAL request: every retry below re-sends the
            # same key, so the master replays rather than re-applies.
            headers["X-Idempotency-Key"] = uuid.uuid4().hex
        safe_to_repeat = method in ("GET", "HEAD") or idempotent
        last_exc: Optional[Exception] = None
        retry_after: Optional[float] = None
        for attempt in range(self.max_retries):
            if attempt:
                self._backoff(attempt - 1, retry_after)
            retry_after = None
            req = urllib.request.Request(url, data=data, headers=headers, method=method)
            try:
                with urllib.request.urlopen(req, timeout=timeout or self.timeout,
                                            context=self._ssl_ctx) as resp:
                    text = resp.read().decode()
                    return json.loads(text) if text else None
            except urllib.error.HTTPError as e:
                body_text = e.read().decode(errors="replace")
                retryable = e.code == 429 or e.code in (502, 503, 504) or (
                    500 <= e.code < 600 and safe_to_repeat
                )
                if retryable and attempt < self.max_retries - 1:
                    ra = e.headers.get("Retry-After") if e.headers else None
                    try:
                        retry_after = float(ra) if ra else None
                    except ValueError:
                        retry_after = None
                    last_exc = e
                else:
                    raise APIError(e.code, body_text, url) from None
            except ssl.SSLCertVerificationError:
                raise  # retrying can't make an untrusted cert trusted
            except (urllib.error.URLError, socket.timeout, ConnectionError,
                    http.client.HTTPException, OSError) as e:
                # http.client.HTTPException covers the mid-RESPONSE failure
                # modes urlopen does NOT wrap in URLError: IncompleteRead /
                # RemoteDisconnected when the peer resets after the status
                # line or partway through the body. Connect-phase errors
                # were always retried; a body cut off mid-read must back
                # off the same way instead of crashing the caller.
                reason = getattr(e, "reason", None)
                if isinstance(reason, ssl.SSLCertVerificationError):
                    raise reason from None
                last_exc = e
        raise ConnectionError(f"master unreachable at {url}: {last_exc}")

    def get(self, path: str, params: Optional[Dict[str, Any]] = None,
            timeout: Optional[float] = None) -> Any:
        return self._request("GET", path, params=params, timeout=timeout)

    def post(self, path: str, body: Optional[Dict[str, Any]] = None,
             params: Optional[Dict[str, Any]] = None,
             idempotent: bool = False) -> Any:
        return self._request("POST", path, body=body, params=params,
                             idempotent=idempotent)

    def patch(self, path: str, body: Optional[Dict[str, Any]] = None) -> Any:
        return self._request("PATCH", path, body=body)

    def delete(self, path: str) -> Any:
        return self._request("DELETE", path)
