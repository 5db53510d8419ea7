"""Per-request span tracing for serve replicas (docs/observability.md
"Request spans", docs/serving.md "Request latency & SLOs").

Every request that retires from the batcher yields a span tree on the
trace whose id IS the request id (minted/propagated as `X-Request-Id` by
the master router; the root span's span_id == the request id, exactly the
trial.lifecycle convention):

  serve.request                      submit → finish (root, replica-side)
  ├── serve.queue_wait               submit → admission
  ├── serve.prefill                  bucket/suffix/prefix-hit/blocks attrs
  └── serve.decode                   tokens/steps/occupancy attrs

The master-side `serve.router.dispatch` span (replica chosen, retries,
breaker state) is recorded directly by the router into the same trace —
`GET /api/v1/deployments/{id}/requests/{rid}/trace` stitches both.

Sampling: errors and SLO breaches (`serving.slo_ms`) are ALWAYS traced;
everything else is traced at `serving.trace_sample` (default 1.0 — drop
it in production if the span volume matters). Spans buffer in memory and
batch-POST to `POST /api/v1/allocations/{id}/request_spans` off the
decode loop; a dead span sink drops the batch and never blocks or fails
a generation — the `serving.trace.drop` fault point (docs/chaos.md)
proves that path deterministically, same contract as `trace.span.drop`.

The port's copy of determined_tpu/serve/tracing.py, built on the port's
common/trace.Span and common/faultpoint; the sink is the port's
common/api.Session.
"""

from __future__ import annotations

import logging
import os
import random
import threading
from typing import Any, Dict, List, Optional

from determined_tpu_torch.common import faultpoint
from determined_tpu_torch.common.trace import Span

logger = logging.getLogger("determined_tpu_torch.serve")

FAULT_TRACE_DROP = "serving.trace.drop"

# Keep at most this many spans buffered when the sink is gone: tracing is
# best-effort by contract and must never become the replica's memory leak.
MAX_BUFFERED_SPANS = 4096


class RequestTracer:
    """Buffered request-span emitter for one serve replica.

    `record()` is called by the batcher at retire (its thread); `flush()`
    runs on the shipper thread (or inline in tests). Local/masterless mode
    (`session=None`) keeps everything in `local_spans` so the same
    instrumentation is inspectable without a cluster.
    """

    def __init__(
        self,
        session=None,
        allocation_id: str = "",
        sample: float = 1.0,
        slo_ms: Optional[float] = None,
        flush_period_s: float = 1.0,
    ):
        self._session = session
        self._allocation_id = allocation_id
        self.sample = min(1.0, max(0.0, float(sample)))
        self.slo_ms = float(slo_ms) if slo_ms else None
        self._period = max(0.1, float(flush_period_s))
        self._buf: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._rng = random.Random()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Observability of the tracer itself.
        self.recorded = 0   # requests that produced a span tree
        self.sampled_out = 0
        self.dropped = 0    # batches lost to sink failure / fault point
        self.slo_breaches = 0
        self.local_spans: List[Dict[str, Any]] = []

    # -- recording (batcher thread) ------------------------------------

    def _should_trace(self, req) -> bool:
        if req.error is not None:
            return True  # errors are always traced
        if self.slo_ms is not None and req.finished_us and req.submitted_us:
            if (req.finished_us - req.submitted_us) / 1e3 > self.slo_ms:
                self.slo_breaches += 1
                return True  # SLO breaches are always traced
        if self.sample >= 1.0:
            return True
        return self._rng.random() < self.sample

    def record(self, req) -> bool:
        """Build the request's span tree and buffer it. Returns True when
        the request was sampled in. Never raises past the batcher."""
        if not self._should_trace(req):
            self.sampled_out += 1
            return False
        spans = self._build_spans(req)
        with self._lock:
            self._buf.extend(spans)
            if len(self._buf) > MAX_BUFFERED_SPANS:
                overflow = len(self._buf) - MAX_BUFFERED_SPANS
                del self._buf[:overflow]
                self.dropped += 1
        self.recorded += 1
        return True

    def _build_spans(self, req) -> List[Dict[str, Any]]:
        rid = req.id
        end_us = req.finished_us or req.submitted_us

        def span(name, start, end, parent, attrs=None):
            sp = Span(rid, name, parent=parent, start_us=int(start),
                      attrs=attrs)
            sp.end_us = int(end)
            return sp

        # Root: span_id == trace_id == request id (the trial.lifecycle
        # convention) so the router's dispatch span parents to it without
        # any replica↔master coordination.
        # Version attrs (docs/serving.md "Model lifecycle"): which model
        # version this replica serves (DET_MODEL_VERSION, pinned by the
        # deployment controller at spawn) and which adapter the request
        # routed to — the trace answers "which weights answered this".
        model_version = os.environ.get("DET_MODEL_VERSION")
        root = span("serve.request", req.submitted_us, end_us, "", {
            "prompt_tokens": int(req.tokens.size),
            "new_tokens": len(req.out_tokens),
            **({"model_version": model_version} if model_version else {}),
            **({"model": req.model}
               if getattr(req, "model", None) else {}),
            **({"error": req.error} if req.error else {}),
        })
        root.span_id = rid
        out = [root.to_dict()]
        if req.admitted_us:
            out.append(span(
                "serve.queue_wait", req.submitted_us, req.admitted_us,
                rid).to_dict())
        if req.prefill_start_us:
            out.append(span(
                "serve.prefill", req.prefill_start_us,
                req.prefill_end_us or end_us, rid, {
                    "bucket": req.bucket,
                    "suffix_len": int(req.tokens.size) - req.cached_len,
                    "prefix_cache_hit": req.cached_len > 0,
                    "cached_len": req.cached_len,
                    "blocks": req.blocks_allocated,
                }).to_dict())
        if req.first_token_us and len(req.out_tokens) > 1:
            out.append(span(
                "serve.decode", req.first_token_us, end_us, rid, {
                    "tokens": len(req.out_tokens),
                    "steps": req.decode_steps,
                    "occupancy_at_admit": req.occupancy_at_admit,
                }).to_dict())
        return out

    # -- shipping ------------------------------------------------------

    def pending(self) -> int:
        with self._lock:
            return len(self._buf)

    def flush(self) -> int:
        """Ship the buffered batch. Never raises: span-sink loss must not
        reach a generation (the zero-failed-requests contract of
        `serving.trace.drop`). Returns spans shipped or locally kept."""
        with self._lock:
            if not self._buf:
                return 0
            batch, self._buf = self._buf, []
        if faultpoint.fire(FAULT_TRACE_DROP) is not faultpoint.Action.NONE:
            logger.warning("faultpoint dropped %d request span(s)",
                           len(batch))
            self.dropped += 1
            return 0
        if self._session is None or not self._allocation_id:
            self.local_spans.extend(batch)
            return len(batch)
        try:
            self._session.post(
                f"/api/v1/allocations/{self._allocation_id}/request_spans",
                body={"spans": batch})
            return len(batch)
        except Exception:
            self.dropped += 1
            logger.warning("request-span flush failed; dropped %d span(s)",
                           len(batch), exc_info=True)
            return 0

    def _run(self) -> None:
        while not self._stop_evt.wait(self._period):
            self.flush()
        self.flush()

    def start(self) -> "RequestTracer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="serve-trace")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.flush()

    def stats(self) -> Dict[str, Any]:
        return {
            "recorded": self.recorded,
            "sampled_out": self.sampled_out,
            "dropped_batches": self.dropped,
            "slo_breaches": self.slo_breaches,
            "pending": self.pending(),
            "sample": self.sample,
            "slo_ms": self.slo_ms,
        }
