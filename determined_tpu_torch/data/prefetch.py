"""Device prefetch: batches staged on the device by a background thread.

Counterpart of determined_tpu/data/prefetch.py. A synchronous copy at the
step that uses a batch puts the host's batch preparation and the
host-to-device copy on the step's path; `DevicePrefetcher` moves both to
a producer thread that runs ahead by a bounded queue (`depth`, default 2):

  - the producer pulls host batches (dicts, lists or tuples of numpy
    arrays or tensors) from the trial's iterable, in order;
  - on CUDA it stages each batch in one set of pinned host buffers that it
    keeps and reuses (a `cudaHostAlloc` per batch would cost more than the
    copy), copies it to the device with `non_blocking=True` on its own
    `torch.cuda.Stream`, records an event and waits for it, as the JAX
    producer blocks until its batch is on the device: `h2d_ms` is its time
    from the copy's issue to that event. Since the producer waits for each
    copy before it stages the next batch, the pinned buffers are free
    again whenever it refills them;
  - the consumer makes its current stream wait on the batch's event (no
    host sync) and calls `record_stream` on each device tensor, so the
    caching allocator never hands a batch's memory to the producer's
    stream while a step may still read it; `input_wait_ms` is the
    consumer's time blocked on the queue;
  - on the CPU (`device="cpu"`) there is no copy and no stream: each leaf
    becomes a tensor and is queued;
  - in a run of several processes each rank's loader yields its own rows
    of the global batch, so a rank stages only those (the counterpart of
    the JAX producer's `make_array_from_process_local_data`);
  - producer exceptions re-raise in the consumer after the batches queued
    before them; `close()` is bounded and idempotent, and `detach()`
    hands back the staged batches and the underlying iterator in order.

Chaos: the producer honours the `data.prefetch.queue` fault point
(`DET_FAULTS=data.prefetch.queue:error` fails the stream,
`...:drop` drops a batch).
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import queue
import threading
import time
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from determined_tpu_torch.common import faultpoint

logger = logging.getLogger("determined_tpu_torch.data")

FAULT_POINT_QUEUE = "data.prefetch.queue"

_SENTINEL = object()


@dataclasses.dataclass
class PrefetchConfig:
    """Resolved prefetch settings (the trial attribute over the experiment
    config's block)::

        prefetch:
          enabled: true     # on by default
          depth: 2          # queue depth; 2 = double buffering

    A trial overrides it with `prefetch = False` or `prefetch = {"depth":
    4}`. (The JAX block's `shard` key has no meaning on one device and is
    ignored.)
    """

    enabled: bool = True
    depth: int = 2

    @classmethod
    def from_block(cls, block: Any) -> "PrefetchConfig":
        if block is None:
            return cls()
        if isinstance(block, bool):
            return cls(enabled=block)
        if isinstance(block, dict):
            return cls(enabled=bool(block.get("enabled", True)),
                       depth=max(1, int(block.get("depth", 2))))
        raise TypeError(f"prefetch config must be a bool or mapping, got "
                        f"{type(block).__name__}")

    @classmethod
    def resolve(cls, trial: Any = None,
                expconf: Optional[Dict[str, Any]] = None) -> "PrefetchConfig":
        """The trial attribute wins over the experiment config's block;
        both default to enabled."""
        trial_attr = getattr(trial, "prefetch", None)
        if trial_attr is not None:
            return cls.from_block(trial_attr)
        if isinstance(expconf, dict) and expconf.get("prefetch") is not None:
            return cls.from_block(expconf.get("prefetch"))
        return cls()


def _map(batch: Any, fn) -> Any:
    """`batch` with `fn` applied to every array or tensor leaf."""
    if isinstance(batch, (np.ndarray, torch.Tensor)):
        return fn(batch)
    if isinstance(batch, dict):
        return {k: _map(v, fn) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map(v, fn) for v in batch)
    return batch


def _leaves(batch: Any) -> Iterator[Any]:
    if isinstance(batch, (np.ndarray, torch.Tensor)):
        yield batch
    elif isinstance(batch, dict):
        for v in batch.values():
            yield from _leaves(v)
    elif isinstance(batch, (list, tuple)):
        for v in batch:
            yield from _leaves(v)


def _as_tensor(x: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


class _PinnedBuffers:
    """Pinned host buffers for one batch, reused while the leaves keep
    their shapes and dtypes."""

    def __init__(self):
        self._bufs: List[torch.Tensor] = []

    def stage(self, batch: Any) -> Any:
        index = itertools.count()

        def fill(x):
            src = _as_tensor(x)
            i = next(index)
            if i == len(self._bufs):
                self._bufs.append(None)
            buf = self._bufs[i]
            if buf is None or buf.shape != src.shape or \
                    buf.dtype != src.dtype:
                buf = self._bufs[i] = torch.empty(
                    src.shape, dtype=src.dtype, pin_memory=True)
            buf.copy_(src)
            return buf

        return _map(batch, fill)


class DevicePrefetcher:
    """Iterator over `iterable`'s batches, staged on `device` by a
    background thread. Finite iterables end with StopIteration; producer
    exceptions re-raise after the batches queued before them. Always
    `close()` it (or use it as a context manager)."""

    THREAD_PREFIX = "data-prefetch"

    def __init__(self, iterable: Iterable[Any],
                 device: Union[str, torch.device], depth: int = 2,
                 name: str = "train"):
        self._it: Iterator[Any] = iter(iterable)
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        if self._cuda and self._device.index is None:
            # The producer thread selects the device by its index.
            self._device = torch.device("cuda", torch.cuda.current_device())
        depth = max(1, int(depth))
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._closed = False
        # A batch the producer had staged when close()/detach() raced its
        # queue put: detach() hands it back so no batch is lost.
        self._overflow: Optional[Any] = None
        self._stream = None
        self._pinned: Optional[_PinnedBuffers] = None
        if self._cuda:
            self._stream = torch.cuda.Stream(device=self._device)
            self._pinned = _PinnedBuffers()
        self._mlock = threading.Lock()
        self._wait_ms_sum = 0.0
        self._h2d_ms_sum = 0.0
        self._depth_sum = 0.0
        self._n = 0
        self._thread = threading.Thread(
            target=self._produce, daemon=True,
            name=f"{self.THREAD_PREFIX}-{name}")
        self._thread.start()

    # -- producer ------------------------------------------------------

    def _stage(self, batch: Any) -> Tuple[Any, Any]:
        """-> (the batch as tensors on the device, its copy's event)."""
        if not self._cuda:
            return _map(batch, _as_tensor), None
        host = self._pinned.stage(batch)
        with torch.cuda.stream(self._stream):
            dev = _map(host, lambda t: t.to(self._device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(self._stream)
        event.synchronize()  # the pinned buffers are free again
        return dev, event

    def _produce(self) -> None:
        try:
            if self._cuda:
                torch.cuda.set_device(self._device)
            while not self._stop.is_set():
                try:
                    batch = next(self._it)
                except StopIteration:
                    break
                action = faultpoint.fire(FAULT_POINT_QUEUE)
                if action is faultpoint.Action.ERROR:
                    raise faultpoint.FaultInjected(FAULT_POINT_QUEUE)
                if action is faultpoint.Action.DROP:
                    continue
                t0 = time.perf_counter()
                dev, event = self._stage(batch)
                h2d_ms = (time.perf_counter() - t0) * 1e3
                if not self._put((dev, event, h2d_ms)):
                    self._overflow = dev
                    return
        except BaseException as e:  # re-raised in the consumer
            self._exc = e
        finally:
            self._put(_SENTINEL)

    def _put(self, item: Any) -> bool:
        """Bounded-queue put that gives up when close() is racing it."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    # -- consumer ------------------------------------------------------

    def __iter__(self) -> "DevicePrefetcher":
        return self

    def __next__(self) -> Any:
        if self._closed:
            raise StopIteration
        t0 = time.perf_counter()
        item = self._q.get()
        wait_ms = (time.perf_counter() - t0) * 1e3
        if item is _SENTINEL:
            self._thread.join(timeout=5.0)
            self._closed = True
            if self._exc is not None:
                exc, self._exc = self._exc, None
                raise exc
            raise StopIteration
        batch, event, h2d_ms = item
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for t in _leaves(batch):
                t.record_stream(stream)
        with self._mlock:
            self._wait_ms_sum += wait_ms
            self._h2d_ms_sum += h2d_ms
            self._depth_sum += self._q.qsize()
            self._n += 1
        return batch

    # -- metrics -------------------------------------------------------

    def window_sums(self) -> Tuple[float, float, float, int]:
        """(input_wait_ms_sum, h2d_ms_sum, queue_depth_sum, n_batches)
        since the last call; resets the window."""
        with self._mlock:
            out = (self._wait_ms_sum, self._h2d_ms_sum, self._depth_sum,
                   self._n)
            self._wait_ms_sum = self._h2d_ms_sum = self._depth_sum = 0.0
            self._n = 0
        return out

    def window_metrics(self) -> Dict[str, float]:
        """Per-batch means over the window ({} when no batch flowed)."""
        wait, h2d, depth, n = self.window_sums()
        if not n:
            return {}
        return {"input_wait_ms": wait / n, "h2d_ms": h2d / n,
                "prefetch_queue_depth": depth / n}

    # -- lifecycle -----------------------------------------------------

    def close(self) -> None:
        """Idempotent teardown: stop the producer, unblock it if the queue
        is full, join it (bounded)."""
        if self._closed and not self._thread.is_alive():
            return
        self._closed = True
        self._stop.set()
        while True:  # drain, so a blocked _put sees _stop
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)
        if self._thread.is_alive():
            logger.warning(
                "prefetch thread %s did not exit within 5s (host iterator "
                "stuck?); it is a daemon and will not block shutdown",
                self._thread.name)

    def detach(self) -> Tuple[list, Iterator[Any]]:
        """Stop prefetching without losing position: returns
        (staged_batches, underlying_iterator), whose chain is the stream a
        continued consumer would have seen. The prefetcher is unusable
        afterwards."""
        self._stop.set()
        self._thread.join(timeout=10.0)
        if self._thread.is_alive():
            raise RuntimeError(
                "prefetch producer did not stop; cannot detach without "
                "risking a lost batch")
        staged: list = []
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not _SENTINEL:
                staged.append(item[0])
        if self._overflow is not None:
            staged.append(self._overflow)
            self._overflow = None
        self._closed = True
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc
        return staged, self._it

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
