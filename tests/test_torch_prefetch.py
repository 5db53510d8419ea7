"""The port's DevicePrefetcher against the JAX package's, on the CPU.

The same seeded numpy iterator goes through
`determined_tpu.data.DevicePrefetcher` (no sharding: host batches queued
as they are) and `determined_tpu_torch.data.DevicePrefetcher`
(`device="cpu"`: each leaf becomes a tensor, no copy, no stream). The
batches must come out bit-identical and in the same order, for finite and
infinite streams; a producer exception re-raises after the batches queued
before it; `DET_FAULTS=data.prefetch.queue:error` / `:drop` act as in
JAX; `close()` leaves no `data-prefetch-*` thread; `detach()` returns the
staged batches and the iterator, whose chain is the rest of the stream;
the window metrics have JAX's keys. `PrefetchConfig.resolve` reads the
trial attribute over the experiment config's block as JAX's does. The
CUDA path (reused pinned buffers, side stream, `record_stream`) is held on the card
by tests/test_torch_cuda.py.
"""

import itertools
import threading
import time

import numpy as np
import pytest
import torch

from determined_tpu.common import faultpoint as jfaultpoint
from determined_tpu.data import DevicePrefetcher as JaxPrefetcher
from determined_tpu.data import PrefetchConfig as JaxPrefetchConfig
from determined_tpu_torch.common import faultpoint
from determined_tpu_torch.data import (
    FAULT_POINT_QUEUE, DevicePrefetcher, PrefetchConfig)


def seeded(n=None, seed=0):
    rng = np.random.default_rng(seed)
    for i in itertools.count() if n is None else range(n):
        yield {"tokens": rng.integers(0, 50257, size=(4, 17)).astype(np.int32),
               "aux": [rng.normal(size=(3,)).astype(np.float32),
                       np.full((2, 2), i, np.int64)]}


def as_numpy(batch):
    if isinstance(batch, torch.Tensor):
        return batch.numpy()
    if isinstance(batch, dict):
        return {k: as_numpy(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return [as_numpy(v) for v in batch]
    return np.asarray(batch)


def assert_same(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        a, b = as_numpy(a), as_numpy(b)
        for x, y in ((a["tokens"], b["tokens"]), (a["aux"][0], b["aux"][0]),
                     (a["aux"][1], b["aux"][1])):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()


def prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("data-prefetch") and t.is_alive()]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("DET_FAULTS", raising=False)
    faultpoint.disarm_all()
    jfaultpoint.disarm_all()
    yield
    faultpoint.disarm_all()
    jfaultpoint.disarm_all()


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_finite_stream_order_is_the_jax_order(depth):
    with DevicePrefetcher(seeded(7), "cpu", depth=depth) as ours, \
            JaxPrefetcher(seeded(7), depth=depth) as theirs:
        got, want = list(ours), list(theirs)
    assert len(got) == 7
    assert_same(got, want)
    assert all(isinstance(b["tokens"], torch.Tensor) for b in got)
    assert next(iter(ours), None) is None  # exhausted stays exhausted


def test_infinite_stream_order_is_the_jax_order():
    ours = DevicePrefetcher(seeded(), "cpu", depth=2)
    theirs = JaxPrefetcher(seeded(), depth=2)
    try:
        got = [next(ours) for _ in range(25)]
        want = [next(theirs) for _ in range(25)]
    finally:
        ours.close()
        theirs.close()
    assert_same(got, want)


def _failing(n):
    yield from seeded(n)
    raise ValueError("loader broke")


def test_a_producer_error_reraises_after_the_queued_batches():
    for cls, kw in ((DevicePrefetcher, {"device": "cpu"}), (JaxPrefetcher, {})):
        got = []
        with cls(_failing(3), depth=8, **kw) as pf:
            time.sleep(0.05)  # all three queued before the error
            with pytest.raises(ValueError, match="loader broke"):
                for b in pf:
                    got.append(b)
        assert_same(got, list(seeded(3)))


@pytest.mark.parametrize("mode", ["error", "drop"])
def test_the_queue_fault_point_acts_as_in_jax(monkeypatch, mode):
    monkeypatch.setenv("DET_FAULTS", f"{FAULT_POINT_QUEUE}:{mode}:2")
    results = {}
    for name, cls, fp, kw in (
            ("torch", DevicePrefetcher, faultpoint, {"device": "cpu"}),
            ("jax", JaxPrefetcher, jfaultpoint, {})):
        fp.reload_env()
        got, err = [], None
        with cls(seeded(5), depth=2, **kw) as pf:
            try:
                for b in pf:
                    got.append(as_numpy(b)["aux"][1][0, 0])
            except Exception as e:  # noqa: BLE001 — compared below
                err = type(e).__name__
        results[name] = (got, err)
    assert results["torch"] == results["jax"]
    # error: the first batch fails the stream; drop: the first two vanish.
    assert results["torch"] == (([], "FaultInjected") if mode == "error"
                                else ([2, 3, 4], None))


def test_close_leaves_no_thread_and_is_idempotent():
    before = len(prefetch_threads())
    pfs = [DevicePrefetcher(seeded(), "cpu", depth=2, name=f"t{i}")
           for i in range(3)]
    next(pfs[0])
    time.sleep(0.05)  # every producer blocked on its full queue
    for pf in pfs:
        pf.close()
        pf.close()
    assert len(prefetch_threads()) == before
    assert next(pfs[0], None) is None


def test_detach_returns_the_rest_of_the_stream_in_order():
    for cls, kw in ((DevicePrefetcher, {"device": "cpu"}), (JaxPrefetcher, {})):
        pf = cls(seeded(), depth=3, **kw)
        head = [next(pf) for _ in range(4)]
        time.sleep(0.05)  # the queue fills
        staged, rest = pf.detach()
        tail = list(itertools.islice(rest, 5))
        assert len(staged) >= 3
        assert_same(head + staged + tail,
                    list(seeded(4 + len(staged) + 5)))
    assert not prefetch_threads()


def test_window_metrics_have_the_jax_keys():
    with DevicePrefetcher(seeded(6), "cpu", depth=2) as ours, \
            JaxPrefetcher(seeded(6), depth=2) as theirs:
        for _ in range(4):
            next(ours)
            next(theirs)
        got, want = ours.window_metrics(), theirs.window_metrics()
        assert set(got) == set(want) == {
            "input_wait_ms", "h2d_ms", "prefetch_queue_depth"}
        assert all(v >= 0 for v in got.values())
        assert got["prefetch_queue_depth"] <= 2
        assert ours.window_sums()[3] == 0  # the window was drained
        next(ours)
        assert ours.window_sums()[3] == 1


class _Trial:
    def __init__(self, prefetch):
        self.prefetch = prefetch


@pytest.mark.parametrize("attr, block, want", [
    (None, None, (True, 2)),
    (False, {"depth": 4}, (False, 2)),
    ({"depth": 4}, False, (True, 4)),
    (None, {"enabled": False, "depth": 3}, (False, 3)),
    (None, {"depth": 0}, (True, 1)),
    (None, True, (True, 2)),
])
def test_prefetch_config_resolves_as_jax(attr, block, want):
    expconf = {"prefetch": block} if block is not None else {}
    ours = PrefetchConfig.resolve(_Trial(attr), expconf)
    theirs = JaxPrefetchConfig.resolve(_Trial(attr), expconf)
    assert (ours.enabled, ours.depth) == (theirs.enabled, theirs.depth) \
        == want
    with pytest.raises(TypeError):
        PrefetchConfig.from_block(3)
