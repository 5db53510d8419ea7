"""HTTP front-end for a serve replica.

Small and dependency-free (http.server, like the exec task servers): one
POST endpoint that blocks until the batcher completes the request, plus
stats/health for load balancers and the master proxy.

  POST /v1/generate   {"tokens": [...], "max_new_tokens": 16,
                       "temperature": 0.0, "eos_id": null,
                       "timeout_s": 120}
      200 {"id", "tokens", "prompt_tokens", "latency_ms", "queue_ms"}
      400 bad request (prompt too long for every bucket, bad body)
      429 admission queue full            (Retry-After: 1)
      503 draining — not admitting        (Retry-After: 5)
      504 request accepted but not finished within timeout_s

  GET /v1/stats       batcher + engine counters (occupancy, KV blocks,
                      queue depth, compile times)
  GET /metrics        the same counters in Prometheus text exposition
                      (docs/observability.md) — a fleet scrape of every
                      node sees serving replicas next to master/agent,
                      and queue depth + occupancy are the autoscaling
                      signal
  GET /healthz        {"status": "ok"|"draining"}

The thread-per-request server is intentional: generate handlers spend
their life blocked on a result event, so threads are cheap, and the
batcher thread is the only device consumer regardless of fan-in.

The port's copy of determined_tpu/serve/http.py, with the same endpoints
and status codes.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from determined_tpu_torch.serve.scheduler import (
    ContinuousBatcher,
    Draining,
    QueueFull,
    Request,
)

logger = logging.getLogger("determined_tpu_torch.serve")

DEFAULT_REQUEST_TIMEOUT_S = 120.0


def _hist_exposition(name: str, wire: Dict[str, Any]) -> list:
    """One histogram in Prometheus text format from the LatencyHist wire
    form (cumulative counts + le boundaries)."""
    lines = [f"# TYPE {name} histogram"]
    les = wire.get("le") or []
    counts = wire.get("counts") or []
    for le, c in zip(les, counts):
        lines.append(f'{name}_bucket{{le="{le}"}} {c}')
    lines.append(f'{name}_bucket{{le="+Inf"}} {wire.get("count", 0)}')
    lines.append(f"{name}_sum {wire.get('sum', 0.0)}")
    lines.append(f"{name}_count {wire.get('count', 0)}")
    return lines


def prometheus_exposition(stats: Dict[str, Any],
                          latency_wire: Optional[Dict[str, Any]] = None
                          ) -> str:
    """Fold ContinuousBatcher.stats() into Prometheus text format (names
    registered in common/metric_names.py SERVE_METRICS). `latency_wire`
    is the heartbeat-form histogram dict ({ttft,tpot,e2e,queue_wait} →
    le/counts/sum/count) — the TTFT/TPOT/e2e/queue-wait SLO histograms of
    docs/serving.md "Request latency & SLOs"."""
    kv = stats.get("kv_blocks", {}) or {}
    lines = [
        "# TYPE det_serve_queue_depth gauge",
        f"det_serve_queue_depth {stats.get('queue_depth', 0)}",
        "# TYPE det_serve_active_requests gauge",
        f"det_serve_active_requests {stats.get('active', 0)}",
        "# TYPE det_serve_draining gauge",
        f"det_serve_draining {1 if stats.get('draining') else 0}",
        "# TYPE det_serve_kv_blocks_free gauge",
        f"det_serve_kv_blocks_free {kv.get('free_blocks', 0)}",
        "# TYPE det_serve_kv_blocks_used gauge",
        f"det_serve_kv_blocks_used {kv.get('used_blocks', 0)}",
        "# TYPE det_serve_kv_blocks_total gauge",
        f"det_serve_kv_blocks_total {kv.get('num_blocks', 0)}",
        "# TYPE det_serve_prefix_cache_hit_rate gauge",
        "det_serve_prefix_cache_hit_rate "
        f"{kv.get('prefix_cache_hit_rate', 0.0)}",
        "# TYPE det_serve_requests_total counter",
        f"det_serve_requests_total {stats.get('completed', 0)}",
        "# TYPE det_serve_tokens_total counter",
        f"det_serve_tokens_total {stats.get('generated_tokens', 0)}",
    ]
    if latency_wire:
        for name, key in (
            ("det_serve_ttft_seconds", "ttft"),
            ("det_serve_tpot_seconds", "tpot"),
            ("det_serve_e2e_seconds", "e2e"),
            ("det_serve_queue_wait_seconds", "queue_wait"),
        ):
            lines.extend(_hist_exposition(name, latency_wire.get(key) or {}))
    return "\n".join(lines) + "\n"


def _make_handler(batcher: ContinuousBatcher):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet: task log carries ours
            logger.debug("http: " + fmt, *args)

        def _send(self, status: int, body: Dict[str, Any],
                  headers: Optional[Dict[str, str]] = None) -> None:
            data = json.dumps(body).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802 — http.server API
            if self.path == "/healthz":
                draining = batcher.queue.draining
                self._send(200, {"status": "draining" if draining
                                 else "ok"})
                return
            if self.path == "/v1/stats":
                stats = batcher.stats()
                stats["engine"] = batcher.engine.stats()
                stats["retry_after_hint_s"] = batcher.retry_after_hint()
                self._send(200, stats)
                return
            if self.path == "/metrics":
                latency = batcher.heartbeat_stats().get("latency")
                data = prometheus_exposition(
                    batcher.stats(), latency_wire=latency).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            self._send(404, {"error": "not found"})

        def do_POST(self):  # noqa: N802
            if self.path != "/v1/generate":
                self._send(404, {"error": "not found"})
                return
            # X-Request-Id names the request's trace: the master router
            # mints one per routed request (accepting a caller-supplied
            # id) and the replica's span tree rides it, so
            # `det serve trace <deployment> <request-id>` finds the whole
            # router→replica tree under one id.
            rid = (self.headers.get("X-Request-Id") or "").strip() or None
            # Adapter routing (docs/serving.md "Model lifecycle"): the
            # `model` body field (or X-Model header) names a resident
            # fine-tune; unknown names 400 below via submit()'s
            # validation — never a silent base-model answer.
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                model = (str(body.get("model")
                             or self.headers.get("X-Model") or "").strip()
                         or None)
                req = Request(
                    tokens=body["tokens"],
                    max_new_tokens=int(body.get("max_new_tokens", 16)),
                    temperature=float(body.get("temperature", 0.0)),
                    eos_id=body.get("eos_id"),
                    request_id=rid,
                    model=model,
                )
                timeout = float(
                    body.get("timeout_s", DEFAULT_REQUEST_TIMEOUT_S))
            except (KeyError, TypeError, ValueError) as e:
                self._send(400, {"error": f"bad request: {e}"})
                return
            try:
                batcher.submit(req)
            except Draining as e:
                self._send(503, {"error": str(e)}, {"Retry-After": "5"})
                return
            except QueueFull as e:
                # Computed backoff: queue depth × smoothed service time
                # over the batch slots — a hint the harness Session (and
                # the master router, which propagates the header) can act
                # on instead of a bare 429.
                hint = str(batcher.retry_after_hint())
                self._send(429, {"error": str(e)}, {"Retry-After": hint})
                return
            except ValueError as e:
                self._send(400, {"error": str(e)})
                return
            rid_hdr = {"X-Request-Id": req.id}
            try:
                self._send(200, req.result(timeout), rid_hdr)
            except TimeoutError:
                self._send(504, {"error": "request timed out",
                                 "id": req.id}, rid_hdr)
            except RuntimeError as e:
                self._send(500, {"error": str(e), "id": req.id}, rid_hdr)

    return Handler


class ServingServer:
    """ThreadingHTTPServer wrapper with deterministic lifecycle."""

    def __init__(self, batcher: ContinuousBatcher, host: str = "0.0.0.0",
                 port: int = 0):
        self.batcher = batcher
        self._httpd = ThreadingHTTPServer(
            (host, port), _make_handler(batcher))
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "ServingServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="serve-http")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
