"""Trial-lifecycle tracing: spans of the training harness.

The port's copy of determined_tpu/common/trace.py for local mode. A span is
`{trace_id, span_id, parent, name, start_us, end_us, attrs}` with wall-clock
epoch microseconds. `span()` and `emit()` append to an in-memory buffer (no
I/O on the step path); `flush()` moves the buffer into `local_spans`, at the
metrics-flush cadence, as the JAX package's tracer does when it has no
master to post to. The master's span sink is not ported (ROADMAP.md:
managed mode). `DET_TRACE_OFF=1` disables emission.
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
    """Buffered span emitter for one trial process (local mode)."""

    def __init__(self, trace_id: Optional[str] = None,
                 enabled: Optional[bool] = None):
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
        self.dropped = 0  # batches lost to the fault point

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
        """Move the buffered batch into `local_spans`; returns its size.
        Never raises."""
        with self._lock:
            if not self._buf:
                return 0
            batch, self._buf = self._buf, []
        if faultpoint.fire(FAULT_SPAN_DROP) is not faultpoint.Action.NONE:
            logger.warning("faultpoint dropped %d span(s)", len(batch))
            self.dropped += 1
            return 0
        self.local_spans.extend(batch)
        return len(batch)

    def close(self) -> None:
        self.flush()
