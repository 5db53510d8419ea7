"""Continuous token-level batcher + bounded admission queue.

The serving analogue of the training input pipeline's producer/consumer
discipline (data/prefetch.py): the HTTP front-end *produces* requests into
a bounded queue (backpressure, never unbounded growth), and a single
batcher thread *consumes* them into the decode loop — the device never
waits on request plumbing, and request plumbing never races the device.

The batching contract (Orca/vLLM-style continuous batching):

  - **join at step boundaries**: new sequences are admitted (prefilled
    into a free slot + KV blocks reserved) only between decode steps —
    never mid-step, so running sequences see zero jitter from joins;
  - **retire without drain**: a sequence that finishes frees its slot and
    KV blocks immediately; remaining sequences keep decoding and the next
    queued request joins at the very next boundary — the batch never
    drains to refill;
  - **drain semantics** (spot preemption / shutdown): `drain()` stops
    admissions at the front door (submit raises Draining → HTTP 503) but
    every accepted request — queued or mid-decode — still completes: an
    accepted request is a promise (the zero-dropped-responses contract of
    docs/cluster-ops.md's drain lifecycle).

Chaos: `serving.request.drop` fires in submit() (docs/chaos.md) — drop
sheds the request as if the queue were full; error fails the submit.

Observability (docs/serving.md "Request latency & SLOs"): every request
records wall-clock phase timestamps (submitted → admitted → prefill →
first token → finished) so retire can fold it into the token-latency
histograms — TTFT, TPOT (inter-token), e2e, queue wait — and hand it to
an attached RequestTracer (serve/tracing.py) for the per-request span
tree. Both are retire-time work: the decode loop itself never touches a
clock beyond the per-step timestamps it already takes.

The port's copy of determined_tpu/serve/scheduler.py, with the same host
logic. Engines are captured as CUDA graphs at `start()`, their kernel
library resolved through the engine's compile farm client when it has one
(warm AOT, docs/compile-farm-torch.md).
"""

from __future__ import annotations

import collections
import itertools
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from determined_tpu_torch.common import faultpoint
from determined_tpu_torch.serve.kv_cache import BlockManager

logger = logging.getLogger("determined_tpu_torch.serve")

FAULT_POINT_DROP = "serving.request.drop"

_req_counter = itertools.count()


def now_us() -> int:
    """Wall-clock epoch microseconds — the span time domain shared with
    the master router's dispatch spans (common/trace.py now_us)."""
    return int(time.time() * 1e6)


# Shared bucket boundaries (seconds) for every serving latency histogram.
# The replica heartbeat ships them with the counts, so the master's
# aggregation and `det_serve_request_seconds` exposition can never drift
# from the replica's binning.
LATENCY_BUCKETS_S = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class LatencyHist:
    """Fixed-bucket latency histogram (cumulative counts, Prometheus `le`
    semantics — the Python twin of the master's Hist struct)."""

    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets=LATENCY_BUCKETS_S):
        self.buckets = tuple(buckets)
        self.counts = [0] * len(self.buckets)
        self.sum = 0.0
        self.count = 0

    def observe(self, seconds: float) -> None:
        seconds = max(0.0, float(seconds))
        for i, le in enumerate(self.buckets):
            if seconds <= le:
                self.counts[i] += 1
        self.sum += seconds
        self.count += 1

    def percentile(self, q: float) -> float:
        """Quantile estimate in seconds, linearly interpolated inside the
        winning bucket (histogram_quantile style). 0 when empty; the last
        boundary when the quantile lands in the +Inf bucket."""
        if self.count <= 0:
            return 0.0
        target = q * self.count
        prev_le, prev_c = 0.0, 0
        for le, c in zip(self.buckets, self.counts):
            if c >= target:
                span = c - prev_c
                frac = (target - prev_c) / span if span > 0 else 1.0
                return prev_le + (le - prev_le) * frac
            prev_le, prev_c = le, c
        return self.buckets[-1]

    def summary(self) -> Dict[str, Any]:
        return {
            "count": self.count,
            "mean_ms": round(self.sum / self.count * 1e3, 3)
            if self.count else 0.0,
            "p50_ms": round(self.percentile(0.5) * 1e3, 3),
            "p99_ms": round(self.percentile(0.99) * 1e3, 3),
        }

    def to_wire(self) -> Dict[str, Any]:
        """Heartbeat form: boundaries + cumulative counts, mergeable
        master-side by summing counts across replicas."""
        return {
            "le": list(self.buckets),
            "counts": list(self.counts),
            "sum": round(self.sum, 6),
            "count": self.count,
        }


class QueueFull(RuntimeError):
    """Admission queue at capacity — retry later (HTTP 429/503)."""


class Draining(RuntimeError):
    """Replica is draining — no new admissions (HTTP 503 + retry)."""


class Request:
    """One generation request: prompt tokens in, generated tokens out."""

    def __init__(
        self,
        tokens,
        max_new_tokens: int = 16,
        temperature: float = 0.0,
        eos_id: Optional[int] = None,
        request_id: Optional[str] = None,
        model: Optional[str] = None,
    ):
        self.id = request_id or f"req-{next(_req_counter)}"
        # Per-request adapter routing (docs/serving.md "Model
        # lifecycle"): which resident fine-tune serves this request;
        # None/"base" = the base checkpoint.
        self.model = model or None
        self.tokens = np.asarray(tokens, np.int32).reshape(-1)
        if self.tokens.size == 0:
            raise ValueError("prompt must contain at least one token")
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.temperature = float(temperature)
        self.eos_id = eos_id
        self.out_tokens: List[int] = []
        self.submitted_at = time.monotonic()
        self.admitted_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.error: Optional[str] = None
        self._done = threading.Event()
        # Wall-clock phase stamps (epoch µs, the span time domain): set by
        # the batcher as the request moves submit → admit → prefill →
        # first token → finish. Consumed at retire by the latency
        # histograms and the RequestTracer's span tree.
        self.submitted_us = now_us()
        self.admitted_us = 0
        self.prefill_start_us = 0
        self.prefill_end_us = 0
        self.first_token_us = 0
        self.finished_us = 0
        # Trace attributes recorded at admission (serve.prefill /
        # serve.decode span attrs).
        self.bucket = 0               # prefill bucket chosen (suffix len)
        self.cached_len = 0           # prefix-cache hit depth in tokens
        self.blocks_allocated = 0     # KV blocks charged at admission
        self.occupancy_at_admit = 0   # active slots when this one joined
        self.decode_steps = 0         # decode steps this request rode

    @property
    def total_budget(self) -> int:
        """Worst-case KV footprint in tokens (prompt + every new token)."""
        return int(self.tokens.size) + self.max_new_tokens

    def _finish(self, error: Optional[str] = None,
                notify: bool = True) -> None:
        self.error = error
        self.finished_at = time.monotonic()
        self.finished_us = now_us()
        # notify=False lets the batcher observe latency + spans BEFORE
        # waiters wake: by the time the HTTP response leaves, the
        # request's trace and histogram entries exist (tests and the
        # drain's final flush rely on that ordering).
        if notify:
            self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        """Block until the request completes; raises on failure/timeout."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.id} not finished")
        if self.error is not None:
            raise RuntimeError(f"request {self.id} failed: {self.error}")
        latency_ms = (self.finished_at - self.submitted_at) * 1e3
        queue_ms = ((self.admitted_at or self.finished_at)
                    - self.submitted_at) * 1e3
        out = {
            "id": self.id,
            "tokens": list(self.out_tokens),
            "prompt_tokens": int(self.tokens.size),
            "latency_ms": round(latency_ms, 3),
            "queue_ms": round(queue_ms, 3),
        }
        if self.first_token_us:
            out["ttft_ms"] = round(
                (self.first_token_us - self.submitted_us) / 1e3, 3)
            if len(self.out_tokens) > 1 and self.finished_us:
                out["tpot_ms"] = round(
                    (self.finished_us - self.first_token_us) / 1e3
                    / (len(self.out_tokens) - 1), 3)
        return out


class AdmissionQueue:
    """Bounded FIFO between the front-end and the batcher.

    submit() applies backpressure (QueueFull) instead of buffering
    unboundedly, and refuses outright while draining — the two failure
    modes a load balancer can act on (retry elsewhere vs back off).
    """

    def __init__(self, maxsize: int = 64):
        self.maxsize = max(1, int(maxsize))
        self._dq: "collections.deque[Request]" = collections.deque()
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._draining = False
        self.rejected_full = 0
        self.rejected_draining = 0
        self.dropped = 0  # serving.request.drop shed count

    @property
    def draining(self) -> bool:
        return self._draining

    def depth(self) -> int:
        with self._lock:
            return len(self._dq)

    def submit(self, req: Request) -> Request:
        action = faultpoint.fire(FAULT_POINT_DROP)
        if action is faultpoint.Action.ERROR:
            raise faultpoint.FaultInjected(FAULT_POINT_DROP)
        with self._lock:
            if self._draining:
                self.rejected_draining += 1
                raise Draining("replica is draining; not admitting")
            if action is faultpoint.Action.DROP:
                self.dropped += 1
                raise QueueFull("request shed (serving.request.drop)")
            if len(self._dq) >= self.maxsize:
                self.rejected_full += 1
                raise QueueFull(
                    f"admission queue at capacity ({self.maxsize})")
            self._dq.append(req)
            self._nonempty.notify_all()
        return req

    def peek(self) -> Optional[Request]:
        with self._lock:
            return self._dq[0] if self._dq else None

    def pop(self) -> Optional[Request]:
        with self._lock:
            return self._dq.popleft() if self._dq else None

    def wait_nonempty(self, timeout: float) -> bool:
        with self._lock:
            if self._dq:
                return True
            self._nonempty.wait(timeout)
            return bool(self._dq)

    def drain(self) -> None:
        with self._lock:
            self._draining = True
            self._nonempty.notify_all()

    def undrain(self) -> None:
        with self._lock:
            self._draining = False


class _Slot:
    __slots__ = ("req", "position", "last_token")

    def __init__(self, req: Request, position: int, last_token: int):
        self.req = req
        self.position = position  # index the NEXT decode step writes at
        self.last_token = last_token


class ContinuousBatcher:
    """The decode loop: admit → step → retire, forever.

    Owns the engine's host-side slot state and the KV block accounting.
    `events` records (kind, request_id, step) tuples — ("admit"/"retire"
    at the boundary they happened) — so tests can assert the
    join-at-boundary / retire-without-drain ordering directly.
    """

    def __init__(
        self,
        engine,
        queue: Optional[AdmissionQueue] = None,
        block_manager: Optional[BlockManager] = None,
        idle_wait_s: float = 0.02,
    ):
        self.engine = engine
        self.queue = queue or AdmissionQueue()
        bm = block_manager
        paged = engine.paged
        if bm is None:
            if paged:
                # Mirror the engine's device pool exactly: tables the
                # manager hands out index real pool blocks.
                bm = BlockManager(num_blocks=engine.num_blocks,
                                  block_size=engine.block_size)
            else:
                # Dense layout: accounting-only pool sized to the cache
                # (slots lanes of max_seq tokens).
                bm = BlockManager(
                    num_blocks=engine.slots * max(
                        1, engine.max_seq_len // 16), block_size=16)
        elif paged:
            # An external manager defines the geometry; sync the device
            # pool to it before compile() allocates the pool and captures
            # the graphs.
            engine.set_block_geometry(bm.block_size, bm.num_blocks)
        self.blocks = bm
        self._idle_wait = idle_wait_s
        self._slots: List[Optional[_Slot]] = [None] * engine.slots
        self._stop_evt = threading.Event()
        self._drained_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()  # events/counters only
        self.events: List[Tuple[str, str, int]] = []
        # Optional per-request span tracer (serve/tracing.py), attached by
        # the task entry point / tests; None = no request tracing.
        self.tracer = None
        self.steps = 0
        self.active_steps = 0      # steps with >= 1 active slot
        self.occupancy_sum = 0     # sum of active slots over active steps
        self.max_occupancy = 0
        self.completed = 0
        self.generated_tokens = 0
        self.failed = 0
        # Per-adapter admission counts ("base" + each resident fine-tune)
        # — the multi-tenant visibility knob on /v1/stats.
        self.adapter_requests: Dict[str, int] = {}
        # EWMA of admit→finish seconds, updated at retire: the basis of
        # the computed Retry-After hint (429s carry an actionable backoff
        # instead of a bare "1"; the master router propagates it).
        self._service_s_ewma = 0.0
        # Token-latency SLO histograms (docs/serving.md "Request latency
        # & SLOs"), observed once per request at retire — exposed on
        # /v1/stats, /metrics, and the master heartbeat.
        self.ttft_hist = LatencyHist()        # submit → first token
        self.tpot_hist = LatencyHist()        # mean inter-token interval
        self.e2e_hist = LatencyHist()         # submit → finished
        self.queue_wait_hist = LatencyHist()  # submit → admitted

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "ContinuousBatcher":
        if self._thread is not None:
            return self
        # Build the kernels and capture every call before the first admit.
        self.engine.compile(farm=getattr(self.engine, "farm", None))
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="serve-batcher")
        self._thread.start()
        return self

    def submit(self, req: Request) -> Request:
        # Validate against engine limits at the front door — a prompt no
        # bucket covers would otherwise poison the batcher thread.
        if req.model is not None:
            # Unknown adapter names 400 here, not in the batcher thread —
            # and never silently fall back to the base model.
            self.engine.adapter_index(req.model)
        if self.engine.bucket_for(int(req.tokens.size)) is None:
            raise ValueError(
                f"prompt length {req.tokens.size} exceeds the largest "
                f"prefill bucket ({self.engine.prefill_buckets[-1]})")
        if req.total_budget > self.engine.max_seq_len:
            raise ValueError(
                f"prompt + max_new_tokens = {req.total_budget} exceeds "
                f"max_seq_len ({self.engine.max_seq_len})")
        if self.blocks.blocks_for_tokens(req.total_budget) > \
                self.blocks.num_blocks:
            raise ValueError(
                f"prompt + max_new_tokens = {req.total_budget} exceeds the "
                f"KV pool ({self.blocks.num_blocks} x "
                f"{self.blocks.block_size}-token blocks) — the request "
                "could never be admitted")
        return self.queue.submit(req)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admitting; wait for queued + in-flight work to finish.

        Returns True when fully drained within `timeout` (None = just
        signal, don't wait)."""
        self.queue.drain()
        if timeout is None:
            return self.idle()
        return self._drained_evt.wait(timeout)

    def stop(self, timeout: float = 10.0) -> None:
        """Hard stop: fail outstanding requests and join the thread."""
        self._stop_evt.set()
        self.queue.drain()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        for slot in self._slots:
            if slot is not None and not slot.req.done():
                slot.req._finish("batcher stopped")
        while True:
            req = self.queue.pop()
            if req is None:
                break
            req._finish("batcher stopped")

    def idle(self) -> bool:
        return self.queue.depth() == 0 and all(
            s is None for s in self._slots)

    def active_count(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    # -- the loop ------------------------------------------------------

    def _run(self) -> None:
        try:
            while not self._stop_evt.is_set():
                self._admit()
                active = [i for i, s in enumerate(self._slots)
                          if s is not None]
                if not active:
                    if self.queue.draining and self.queue.depth() == 0:
                        self._drained_evt.set()
                        if self._stop_evt.wait(self._idle_wait):
                            return
                        continue
                    self.queue.wait_nonempty(self._idle_wait)
                    continue
                self._drained_evt.clear()
                self._step(active)
        except BaseException as e:  # noqa: BLE001 — fail open requests
            logger.exception("batcher loop failed")
            msg = f"{type(e).__name__}: {e}"
            for slot in self._slots:
                if slot is not None:
                    slot.req._finish(msg)
                    self.failed += 1
            self._slots = [None] * self.engine.slots
            while True:
                req = self.queue.pop()
                if req is None:
                    break
                req._finish(msg)
                self.failed += 1
            self._drained_evt.set()

    def _admit(self) -> None:
        """Join queued requests at this step boundary while a free slot
        AND enough KV blocks exist (block exhaustion keeps the request
        queued — backpressure, not failure).

        Paged engines admit through BlockManager.admit: a prompt whose
        prefix is cached reuses those blocks (refcounted) and is charged
        only its novel suffix — prefill then runs only that suffix."""
        paged = self.engine.paged
        while True:
            free = [i for i, s in enumerate(self._slots) if s is None]
            if not free:
                return
            req = self.queue.peek()
            if req is None:
                return
            cached_len = 0
            cow_pairs = ()
            if paged:
                admitted = self.blocks.admit(
                    req.id, req.tokens.tolist(), req.total_budget)
                if admitted is None:
                    return  # pool exhausted: wait for a retire
                table, cached_len, cow_pairs = admitted
            else:
                table = self.blocks.allocate(req.id, req.total_budget)
                if table is None:
                    return  # pool exhausted: wait for a retire
            popped = self.queue.pop()
            assert popped is req, "single-consumer queue invariant"
            slot_id = free[0]
            req.admitted_at = time.monotonic()
            req.admitted_us = now_us()
            req.cached_len = cached_len
            req.occupancy_at_admit = self.engine.slots - len(free) + 1
            req.blocks_allocated = (
                len(table) if paged
                else self.blocks.blocks_for_tokens(req.total_budget))
            req.bucket = self.engine.bucket_for(
                int(req.tokens.size) - cached_len) or 0
            req.prefill_start_us = req.admitted_us
            try:
                # Adapter routing: resolve the request's `model:` name to
                # its stack index (0 = base). Validated at submit; a
                # request that snuck past still fails HERE as a per-
                # request error, never a batcher crash.
                adapter = self.engine.adapter_index(req.model)
                # Device-side copy-on-write BEFORE any write can land in
                # a block other sequences still reference.
                for src, dst in cow_pairs:
                    self.engine.copy_block(src, dst)
                if paged:
                    first = self.engine.prefill_request(
                        slot_id, req.tokens, req.temperature,
                        block_table=table, cached_len=cached_len,
                        adapter=adapter)
                else:
                    first = self.engine.prefill_request(
                        slot_id, req.tokens, req.temperature,
                        adapter=adapter)
            except Exception as e:
                # discard=True: the blocks' K/V were never (fully)
                # written; they must not linger in the prefix cache.
                self.blocks.free(req.id, discard=True)
                req._finish(f"prefill failed: {type(e).__name__}: {e}",
                            notify=False)
                self.failed += 1
                self._observe_finished(req)
                req._done.set()
                continue
            req.prefill_end_us = req.first_token_us = now_us()
            req.out_tokens.append(first)
            with self._lock:
                self.events.append(("admit", req.id, self.steps))
                name = req.model or "base"
                self.adapter_requests[name] = \
                    self.adapter_requests.get(name, 0) + 1
            self.generated_tokens += 1
            if self._finished(req, first):
                self._retire(slot_id, req, admitted_only=True)
                continue
            self._slots[slot_id] = _Slot(
                req, position=int(req.tokens.size), last_token=first)

    def _step(self, active: List[int]) -> None:
        slots = self.engine.slots
        tokens = np.zeros((slots,), np.int32)
        positions = np.zeros((slots,), np.int32)
        temps = np.zeros((slots,), np.float32)
        for i in active:
            s = self._slots[i]
            tokens[i] = s.last_token
            positions[i] = s.position
            temps[i] = s.req.temperature
        next_tokens = self.engine.decode(tokens, positions, temps)
        with self._lock:
            self.steps += 1
            self.active_steps += 1
            self.occupancy_sum += len(active)
            self.max_occupancy = max(self.max_occupancy, len(active))
        for i in active:
            s = self._slots[i]
            tok = int(next_tokens[i])
            s.req.out_tokens.append(tok)
            s.req.decode_steps += 1
            self.generated_tokens += 1
            s.position += 1
            s.last_token = tok
            if self._finished(s.req, tok):
                self._retire(i, s.req)

    @staticmethod
    def _finished(req: Request, token: int) -> bool:
        return (len(req.out_tokens) >= req.max_new_tokens
                or (req.eos_id is not None and token == req.eos_id))

    def _retire(self, slot_id: int, req: Request,
                admitted_only: bool = False) -> None:
        """Free the slot + KV blocks and complete the request — the rest
        of the batch keeps decoding (no drain)."""
        if not admitted_only:
            self._slots[slot_id] = None
        # The retired slot keeps riding the decode batch as an inactive
        # lane (position 0). Paged: its table must point at the trash block
        # so that lane's dead write can never land in a block the pool
        # hands to the next sequence. Either layout: its adapter goes back
        # to base.
        self.engine.release_slot(slot_id)
        self.blocks.free(req.id)
        req._finish(notify=False)
        with self._lock:
            self.events.append(("retire", req.id, self.steps))
            self.completed += 1
            if req.admitted_at is not None:
                service_s = max(0.0, req.finished_at - req.admitted_at)
                alpha = 0.2
                self._service_s_ewma = (
                    service_s if self._service_s_ewma == 0.0
                    else alpha * service_s
                    + (1 - alpha) * self._service_s_ewma)
        self._observe_finished(req)
        req._done.set()

    def _observe_finished(self, req: Request) -> None:
        """Retire-time observability: fold the request into the latency
        histograms and hand it to the tracer (which samples + buffers;
        span-sink loss can never reach the decode loop)."""
        with self._lock:
            self.e2e_hist.observe(
                (req.finished_us - req.submitted_us) / 1e6)
            if req.admitted_us:
                self.queue_wait_hist.observe(
                    (req.admitted_us - req.submitted_us) / 1e6)
            if req.first_token_us:
                self.ttft_hist.observe(
                    (req.first_token_us - req.submitted_us) / 1e6)
                if len(req.out_tokens) > 1 and req.finished_us:
                    self.tpot_hist.observe(
                        (req.finished_us - req.first_token_us) / 1e6
                        / (len(req.out_tokens) - 1))
        tracer = self.tracer
        if tracer is not None:
            try:
                tracer.record(req)
            except Exception:
                logger.warning("request tracer failed", exc_info=True)

    # -- stats ---------------------------------------------------------

    def retry_after_hint(self) -> int:
        """Seconds a 429'd client should wait before retrying: the time
        until a queue slot plausibly frees, from the queue depth and the
        smoothed per-request service time spread over the batch slots.
        Clamped to [1, 60] so a cold or idle replica still answers 1."""
        with self._lock:
            service = self._service_s_ewma
        depth = self.queue.depth()
        if service <= 0.0 or depth <= 0:
            return 1
        est = depth * service / max(1, self.engine.slots)
        return max(1, min(60, int(est + 0.999)))

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            occ = (self.occupancy_sum / self.active_steps
                   if self.active_steps else 0.0)
            return {
                "queue_depth": self.queue.depth(),
                "queue_capacity": self.queue.maxsize,
                "draining": self.queue.draining,
                "active": self.active_count(),
                "slots": self.engine.slots,
                "steps": self.steps,
                "mean_occupancy": round(occ, 3),
                "max_occupancy": self.max_occupancy,
                "completed": self.completed,
                "failed": self.failed,
                "generated_tokens": self.generated_tokens,
                "rejected_full": self.queue.rejected_full,
                "rejected_draining": self.queue.rejected_draining,
                "dropped": self.queue.dropped,
                "adapter_requests": dict(self.adapter_requests),
                "kv_blocks": self.blocks.stats(),
                "latency": {
                    "ttft": self.ttft_hist.summary(),
                    "tpot": self.tpot_hist.summary(),
                    "e2e": self.e2e_hist.summary(),
                    "queue_wait": self.queue_wait_hist.summary(),
                },
            }

    def heartbeat_stats(self) -> Dict[str, Any]:
        """The load-report subset pushed to the master on the replica
        heartbeat (POST /allocations/{id}/serve_stats): the router's
        least-loaded signal and the deployment autoscaler's input."""
        kv = self.blocks.stats()
        with self._lock:
            latency = {
                "ttft": self.ttft_hist.to_wire(),
                "tpot": self.tpot_hist.to_wire(),
                "e2e": self.e2e_hist.to_wire(),
                "queue_wait": self.queue_wait_hist.to_wire(),
            }
        return {
            "queue_depth": self.queue.depth(),
            "queue_capacity": self.queue.maxsize,
            "active": self.active_count(),
            "slots": self.engine.slots,
            "kv_blocks_free": kv.get("free_blocks", 0),
            "kv_blocks_used": kv.get("used_blocks", 0),
            "kv_blocks_total": kv.get("num_blocks", 0),
            "prefix_cache_hit_rate": kv.get("prefix_cache_hit_rate", 0.0),
            "draining": self.queue.draining,
            "retry_after_hint_s": self.retry_after_hint(),
            # Mergeable latency histograms (boundaries + cumulative
            # counts): the master sums counts across fresh replicas into
            # the per-deployment p50/p99 on the deployment APIs and the
            # det_serve_request_seconds{deployment=...} exposition.
            "latency": latency,
        }
