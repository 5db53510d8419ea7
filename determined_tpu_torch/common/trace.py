"""Trial-lifecycle tracing: spans of the training harness.

The port's copy of determined_tpu/common/trace.py. A span is
`{trace_id, span_id, parent, name, start_us, end_us, attrs}` with wall-clock
epoch microseconds. `span()` and `emit()` append to an in-memory buffer (no
I/O on the step path); `flush()`, at the metrics-flush cadence and on
`close()`, posts the batch to the master's span sink
(`POST /api/v1/trials/{id}/spans`, idempotency-keyed) in managed mode, or
moves it into `local_spans` without a master. A lost sink never hurts the
trial: a failed post logs and drops the batch. `DET_TRACE_OFF=1` disables
emission. `render_waterfall` draws a trace as `det trial trace` prints it.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from determined_tpu_torch.common import faultpoint

logger = logging.getLogger("determined_tpu_torch.common")

FAULT_SPAN_DROP = "trace.span.drop"


def now_us() -> int:
    """Wall-clock epoch microseconds."""
    return int(time.time() * 1e6)


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


class Span:
    __slots__ = ("trace_id", "span_id", "parent", "name", "start_us",
                 "end_us", "attrs")

    def __init__(self, trace_id: str, name: str, parent: str = "",
                 start_us: Optional[int] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.trace_id = trace_id
        self.span_id = new_span_id()
        self.parent = parent
        self.name = name
        self.start_us = start_us if start_us is not None else now_us()
        self.end_us = 0
        self.attrs = dict(attrs or {})

    def to_dict(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent": self.parent,
            "name": self.name,
            "start_us": self.start_us,
            "end_us": self.end_us,
            "attrs": self.attrs,
        }


class Tracer:
    """Buffered span emitter for one trial process. Chief-only: core.init
    builds it with the session on the chief alone."""

    def __init__(self, session=None, trial_id: int = 0,
                 trace_id: Optional[str] = None,
                 enabled: Optional[bool] = None):
        self._session = session
        self._trial_id = trial_id
        self.trace_id = trace_id or os.environ.get("DET_TRACE_ID") or \
            uuid.uuid4().hex[:16]
        if enabled is None:
            enabled = os.environ.get("DET_TRACE_OFF", "") not in ("1", "true")
        self.enabled = enabled
        # Without a master there is no root span; parentage resolves to the
        # trace id, as in the JAX package's local mode.
        self.root_span_id = self.trace_id
        self._buf: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._tls = threading.local()  # per-thread current-parent stack
        self.local_spans: List[Dict[str, Any]] = []
        self.dropped = 0  # batches lost to the fault point or the sink

    def _parent(self) -> str:
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else self.root_span_id

    def emit(self, name: str, start_us: int, end_us: int,
             attrs: Optional[Dict[str, Any]] = None,
             parent: Optional[str] = None) -> Optional[Span]:
        """Record a completed span (buffer append only; no I/O)."""
        if not self.enabled:
            return None
        sp = Span(self.trace_id, name,
                  parent=parent if parent is not None else self._parent(),
                  start_us=start_us, attrs=attrs)
        sp.end_us = end_us
        with self._lock:
            self._buf.append(sp.to_dict())
        return sp

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Context manager: times the block, nests children under it.
        Yields the Span (attrs may be amended inside the block);
        exceptions propagate after the span is recorded with `error` set."""
        if not self.enabled:
            yield None
            return
        sp = Span(self.trace_id, name, parent=self._parent(), attrs=attrs)
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        stack.append(sp.span_id)
        try:
            yield sp
        except BaseException as e:
            sp.attrs["error"] = type(e).__name__
            raise
        finally:
            stack.pop()
            sp.end_us = now_us()
            with self._lock:
                self._buf.append(sp.to_dict())

    def flush(self) -> int:
        """Ship the buffered batch (post it, or keep it in `local_spans`
        without a master); returns the spans shipped. Never raises."""
        with self._lock:
            if not self._buf:
                return 0
            batch, self._buf = self._buf, []
        if faultpoint.fire(FAULT_SPAN_DROP) is not faultpoint.Action.NONE:
            logger.warning("faultpoint dropped %d span(s)", len(batch))
            self.dropped += 1
            return 0
        if self._session is None:
            self.local_spans.extend(batch)
            return len(batch)
        try:
            # Idempotent: a retry after a lost response must not insert the
            # batch twice.
            self._session.post(f"/api/v1/trials/{self._trial_id}/spans",
                               body={"spans": batch}, idempotent=True)
            return len(batch)
        except Exception:
            self.dropped += 1
            logger.warning("span flush failed; dropped %d span(s)",
                           len(batch), exc_info=True)
            return 0

    def close(self) -> None:
        self.flush()


def render_waterfall(spans: List[Dict[str, Any]], width: int = 48) -> str:
    """Text waterfall for `det trial trace` — one line per span, indented
    by parentage, with an offset-scaled duration bar."""
    if not spans:
        return "(no spans)"
    spans = sorted(spans, key=lambda s: (int(s.get("start_us", 0) or 0)))
    by_id = {s["span_id"]: s for s in spans if s.get("span_id")}

    def depth(s, limit=16):
        d, cur = 0, s
        while d < limit:
            p = cur.get("parent") or ""
            if not p or p not in by_id or p == cur.get("span_id"):
                break
            cur = by_id[p]
            d += 1
        return d

    t0 = min(int(s.get("start_us", 0) or 0) for s in spans)
    ends = [int(s.get("end_us", 0) or 0) for s in spans]
    t1 = max([e for e in ends if e] + [t0 + 1])
    scale = max(t1 - t0, 1)
    name_w = max(len("  " * depth(s) + s.get("name", "?")) for s in spans)
    lines = [f"{'span':<{name_w}}  {'start_ms':>9} {'dur_ms':>9}  timeline"]
    for s in spans:
        start = int(s.get("start_us", 0) or 0)
        end = int(s.get("end_us", 0) or 0)
        off_ms = (start - t0) / 1000.0
        dur_ms = (end - start) / 1000.0 if end else float("nan")
        lo = int((start - t0) / scale * width)
        hi = int(((end if end else t1) - t0) / scale * width)
        bar = " " * lo + ("#" * max(hi - lo, 1) if end else "~" * max(width - lo, 1))
        label = "  " * depth(s) + s.get("name", "?")
        dur = f"{dur_ms:9.1f}" if end else "  running"
        lines.append(f"{label:<{name_w}}  {off_ms:9.1f} {dur}  |{bar}|")
    return "\n".join(lines)
