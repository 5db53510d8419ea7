"""The port's serve replica around the engine: heartbeat, request tracing,
checkpoint restore through the integrity lineage, and the master-attached
entry point.

  - `ReplicaHeartbeat` against a fake session: the path and body the JAX
    package's heartbeat posts for the same batcher (the load report plus
    `model_version` and `adapters`), and no thread without a session;
  - `RequestTracer` against the JAX tracer for the same request record
    (the same span tree), its sampling, the `serving.trace.drop` fault
    point and a dead sink (no generation fails), and its wiring into the
    batcher;
  - `load_checkpoint_params` over checkpoints the port's CheckpointContext
    wrote: "latest" is the newest COMPLETED, a corrupt latest falls back,
    an explicit id extends its lineage, nothing COMPLETED raises;
    `build_replica` restores the base and an adapter from them, and an
    adapter that is not an explicit id resolves in the base checkpoint's
    trial (`_trial_id_for`, as the JAX function resolves it);
  - `compile()` runs the sampler at both of its shapes and records
    `sample_s`, as the JAX engine's compile does, without drawing from the
    engine's generator;
  - `main()` attached to a fake master: proxy address, ready, heartbeats,
    request spans and the drain report, then exit 0 on SIGTERM; and a
    drain on the allocation's preemption signal, which finishes the
    request in flight, acks the signal and exits 0.
"""

import os
import time

import jax
import numpy as np
import pytest
import torch

from determined_tpu.models import gpt2 as jgpt2
from determined_tpu.serve.task import ReplicaHeartbeat as JaxHeartbeat
from determined_tpu.serve.task import _trial_id_for as jax_trial_id_for
from determined_tpu.serve.tracing import RequestTracer as JaxTracer
from determined_tpu_torch.common import faultpoint
from determined_tpu_torch.core._checkpoint import CheckpointContext
from determined_tpu_torch.models import gpt2 as tgpt2
from determined_tpu_torch.serve import (
    AdmissionQueue, ContinuousBatcher, Request, ServingEngine)
from determined_tpu_torch.serve.task import ReplicaHeartbeat, _trial_id_for
from determined_tpu_torch.serve.tracing import FAULT_TRACE_DROP, RequestTracer
from determined_tpu_torch.train.state import TrainState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"vocab_size": 128, "n_positions": 64, "d_model": 32, "n_layer": 2,
        "n_head": 2}
TCFG = tgpt2.Config(**TINY, dtype=torch.float32)
PROMPT = [5, 9, 17, 3]


@pytest.fixture(autouse=True)
def _clean_faults():
    faultpoint.disarm_all()
    yield
    faultpoint.disarm_all()


@pytest.fixture(scope="module")
def params():
    """Numpy params in the JAX init's structure, with a wide spread."""
    rng = np.random.default_rng(0)
    jcfg = jgpt2.Config(**TINY, remat=False, attention_impl="dot")
    shapes = jax.eval_shape(lambda: jgpt2.init(jax.random.PRNGKey(0), jcfg))

    def draw(path, sd):
        if "scale" in jax.tree_util.keystr(path):
            return (1 + 0.1 * rng.normal(size=sd.shape)).astype(np.float32)
        return (0.3 * rng.normal(size=sd.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def finetune(params, seed):
    ft = dict(params)
    ft["wte"] = (params["wte"] + 0.5 * np.random.default_rng(seed).normal(
        size=params["wte"].shape)).astype(np.float32)
    return ft


def _batcher(params, adapters=None):
    eng = ServingEngine(params, TCFG, slots=2, max_seq_len=32,
                        prefill_buckets=[8, 16], kv_block_size=8,
                        adapters=adapters, device="cpu")
    return ContinuousBatcher(eng, queue=AdmissionQueue(16),
                             idle_wait_s=0.005)


class FakeSession:
    def __init__(self):
        self.posts = []

    def post(self, path, body=None, **kw):
        self.posts.append((path, body))


# ---------------------------------------------------------------- heartbeat


def test_heartbeat_posts_what_the_jax_heartbeat_posts(params, monkeypatch):
    monkeypatch.setenv("DET_MODEL_VERSION", "v3")
    b = _batcher(params, adapters={"ft": finetune(params, 7)})
    ours, theirs = FakeSession(), FakeSession()
    ReplicaHeartbeat(ours, "alloc-1", b).beat()
    JaxHeartbeat(theirs, "alloc-1", b).beat()
    assert ours.posts == theirs.posts
    path, body = ours.posts[0]
    assert path == "/api/v1/allocations/alloc-1/serve_stats"
    assert body["model_version"] == "v3" and body["adapters"] == ["ft"]
    assert body["slots"] == 2 and body["draining"] is False
    assert body["kv_blocks_total"] == b.blocks.num_blocks


def test_heartbeat_thread_only_with_a_session(params):
    b = _batcher(params)
    local = ReplicaHeartbeat(None, "", b).start()
    assert local._thread is None
    local.beat()
    local.stop()
    session = FakeSession()
    hb = ReplicaHeartbeat(session, "alloc-2", b, period_s=0.2).start()
    try:
        deadline = time.monotonic() + 10
        while not session.posts and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        hb.stop()
    assert session.posts and hb._thread is None
    assert "adapters" not in session.posts[0][1]  # none resident


# ------------------------------------------------------------------ tracing


def _record(rid, error=None, e2e_ms=5.0, cached_len=0):
    """A retired request's record, stamps set by hand."""
    r = Request(PROMPT, max_new_tokens=3, request_id=rid, model="ft")
    r.admitted_us = r.submitted_us + 100
    r.prefill_start_us = r.admitted_us
    r.prefill_end_us = r.first_token_us = r.admitted_us + 200
    r.out_tokens = [1, 2, 3]
    r.bucket, r.cached_len, r.blocks_allocated = 8, cached_len, 1
    r.occupancy_at_admit, r.decode_steps = 2, 2
    r.error = error
    r.finished_us = r.submitted_us + int(e2e_ms * 1000)
    return r


def test_span_tree_equals_the_jax_tracers(monkeypatch):
    monkeypatch.setenv("DET_MODEL_VERSION", "v3")
    records = [_record("ok-1"), _record("hit-2", cached_len=2),
               _record("err-3", error="boom")]
    trees = []
    for tracer in (RequestTracer(None, ""), JaxTracer(None, "")):
        for r in records:
            assert tracer.record(r)
        assert tracer.flush() == len(tracer.local_spans)
        # Child span ids are random: compare them by their place.
        trees.append([{**s, "span_id": s["span_id"] if s["parent"] == ""
                       else "child"} for s in tracer.local_spans])
    assert trees[0] == trees[1]
    names = [s["name"] for s in trees[0] if s["trace_id"] == "ok-1"]
    assert names == ["serve.request", "serve.queue_wait", "serve.prefill",
                     "serve.decode"]
    root = trees[0][0]
    assert root["span_id"] == "ok-1" and root["attrs"] == {
        "prompt_tokens": 4, "new_tokens": 3, "model_version": "v3",
        "model": "ft"}


def test_tracer_sampling_error_and_slo():
    tracer = RequestTracer(None, "", sample=0.0, slo_ms=100.0)
    assert tracer.record(_record("healthy")) is False
    assert tracer.record(_record("failed", error="boom")) is True
    assert tracer.record(_record("slow", e2e_ms=500.0)) is True
    assert tracer.sampled_out == 1 and tracer.slo_breaches == 1
    tracer.flush()
    assert {s["trace_id"] for s in tracer.local_spans} == {"failed", "slow"}


def test_tracer_in_the_batcher_survives_drop_and_a_dead_sink(params):
    """Spans of requests the batcher retires reach the tracer; with
    `serving.trace.drop` armed, then with a dead sink, batches drop and no
    generation blocks or fails."""
    class DeadSink:
        posts = 0

        def post(self, *a, **kw):
            DeadSink.posts += 1
            raise ConnectionError("span sink is gone")

    local = RequestTracer(None, "")
    b = _batcher(params)
    b.tracer = local
    b.start()
    try:
        b.submit(Request(PROMPT, max_new_tokens=4,
                         request_id="tree-1")).result(timeout=60)
        local.flush()
        by_name = {s["name"]: s for s in local.local_spans}
        assert set(by_name) == {"serve.request", "serve.queue_wait",
                                "serve.prefill", "serve.decode"}
        assert by_name["serve.decode"]["attrs"]["steps"] == 3
        assert by_name["serve.prefill"]["attrs"]["suffix_len"] == 4

        dead = RequestTracer(DeadSink(), "alloc-x")
        b.tracer = dead
        faultpoint.arm(FAULT_TRACE_DROP, "drop", count=1)
        assert b.submit(Request(PROMPT, max_new_tokens=3)).result(60)
        assert dead.pending() > 0 and dead.flush() == 0
        assert dead.dropped == 1 and DeadSink.posts == 0
        reqs = [b.submit(Request(PROMPT, max_new_tokens=3))
                for _ in range(3)]
        assert all(r.result(timeout=60)["tokens"] for r in reqs)
        assert dead.flush() == 0 and DeadSink.posts == 1
        assert dead.dropped == 2
        assert b.failed == 0 and b.stats()["completed"] == 5
    finally:
        b.stop()


# --------------------------------------------------------------- checkpoints


def _save(base, params, steps, trial_id=0):
    """A TrainState checkpoint as `Trainer.fit` writes it."""
    ctx = CheckpointContext(str(base), trial_id=trial_id)
    state = TrainState(step=steps, params=tgpt2.params_from_numpy(params),
                       opt_state={"count": steps})
    return ctx.save_state(state, steps)


def _truncate(base, sid):
    victim = os.path.join(str(base), sid, "state", "state.pt")
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)


def _wte(loaded):
    return np.asarray(loaded["wte"])


def _serve_config(base, **serving):
    return {"serving": {"model_config": {**TINY, "dtype": "float32"},
                        "max_batch_size": 2, "max_seq_len": 32,
                        "kv_block_size": 8, "prefill_buckets": [8, 16],
                        "device": "cpu", **serving},
            "checkpoint_storage": {"type": "shared_fs",
                                   "host_path": str(base)}}


def _generate(batcher, model=None):
    batcher.start()
    try:
        return batcher.submit(Request(PROMPT, max_new_tokens=6,
                                      model=model)).result(60)["tokens"]
    finally:
        batcher.stop()


@pytest.mark.parametrize("serving", [
    {}, {"checkpoint": "latest", "trial_id": 4},
    {"checkpoint": "trial5-step3", "trial_id": 4},
    {"checkpoint": "trial12-step0"}, {"checkpoint": "/x/params.npz"},
])
def test_the_trial_of_a_checkpoint_is_the_jax_one(serving):
    assert _trial_id_for(serving) == jax_trial_id_for(serving)


# ------------------------------------------------------- master-attached main


