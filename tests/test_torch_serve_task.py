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

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch

from determined_tpu.models import gpt2 as jgpt2
from determined_tpu.serve.engine import ServingEngine as JaxEngine
from determined_tpu.serve.task import ReplicaHeartbeat as JaxHeartbeat
from determined_tpu.serve.task import _trial_id_for as jax_trial_id_for
from determined_tpu.serve.tracing import RequestTracer as JaxTracer
from determined_tpu_torch.common import faultpoint
from determined_tpu_torch.core import _integrity
from determined_tpu_torch.core._checkpoint import CheckpointContext
from determined_tpu_torch.models import gpt2 as tgpt2
from determined_tpu_torch.serve import (
    AdmissionQueue, ContinuousBatcher, Request, ServingEngine)
from determined_tpu_torch.serve.engine import load_checkpoint_params
from determined_tpu_torch.serve import model as smodel
from determined_tpu_torch.serve.task import (
    ReplicaHeartbeat, _trial_id_for, build_replica, checkpoint_base)
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


def test_load_checkpoint_params_walks_the_lineage(tmp_path, params):
    ft = finetune(params, 7)
    _save(tmp_path, params, 2)
    _save(tmp_path, ft, 4)
    ctx = CheckpointContext(str(tmp_path))  # a fresh process: a dir scan
    assert ctx.lineage() == ["trial0-step4", "trial0-step2"]
    np.testing.assert_array_equal(
        _wte(load_checkpoint_params(ctx, "latest")), ft["wte"])
    np.testing.assert_array_equal(
        _wte(load_checkpoint_params(ctx, "trial0-step2")), params["wte"])
    # An explicit id that is gone extends its candidates with the lineage.
    np.testing.assert_array_equal(
        _wte(load_checkpoint_params(ctx, "trial0-step9")), ft["wte"])
    _truncate(tmp_path, "trial0-step4")
    for sid in ("latest", "trial0-step4"):  # corrupt: falls back to step 2
        np.testing.assert_array_equal(
            _wte(load_checkpoint_params(ctx, sid)), params["wte"])
    _truncate(tmp_path, "trial0-step2")
    with pytest.raises(_integrity.CorruptCheckpoint):
        load_checkpoint_params(ctx, "latest")


def test_nothing_completed_raises(tmp_path, params):
    with pytest.raises(FileNotFoundError, match="COMPLETED"):
        load_checkpoint_params(CheckpointContext(str(tmp_path)), "latest")
    faultpoint.arm(_integrity.FAULT_COMMIT_DROP, "drop", count=1)
    _save(tmp_path, params, 2)  # PARTIAL: no COMMIT marker
    ctx = CheckpointContext(str(tmp_path))
    assert ctx.lineage() == []
    with pytest.raises(FileNotFoundError, match="COMPLETED"):
        load_checkpoint_params(ctx, "latest")
    with pytest.raises(_integrity.CorruptCheckpoint, match="COMMIT"):
        load_checkpoint_params(ctx, "trial0-step2")


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


def test_build_replica_restores_base_and_adapter(tmp_path, params):
    ft = finetune(params, 7)
    _save(tmp_path, params, 3)
    _save(tmp_path, ft, 5, trial_id=1)  # the fine-tune's own trial
    engine, batcher = build_replica(_serve_config(
        tmp_path, checkpoint="latest",
        adapters=[{"name": "ft", "checkpoint": "trial1-step5"}]))
    assert engine.adapter_names == ["ft"] and engine.device.type == "cpu"
    base_tokens = _generate(batcher)
    ft_tokens = _generate(ContinuousBatcher(engine), model="ft")
    assert base_tokens == _generate(_batcher(params))
    assert ft_tokens == _generate(_batcher(ft))
    assert ft_tokens != base_tokens


@pytest.mark.parametrize("serving", [
    {}, {"checkpoint": "latest", "trial_id": 4},
    {"checkpoint": "trial5-step3", "trial_id": 4},
    {"checkpoint": "trial12-step0"}, {"checkpoint": "/x/params.npz"},
])
def test_the_trial_of_a_checkpoint_is_the_jax_one(serving):
    assert _trial_id_for(serving) == jax_trial_id_for(serving)


def test_an_adapter_resolves_in_the_base_checkpoints_trial(tmp_path,
                                                           params):
    """Checkpoints in trial 5 only; the base names one of them and the
    adapter says `latest`: it is trial 5's newest, not trial 0's (which
    has none)."""
    ft = finetune(params, 7)
    _save(tmp_path, params, 3, trial_id=5)
    _save(tmp_path, ft, 4, trial_id=5)
    config = _serve_config(tmp_path, checkpoint="trial5-step3",
                           adapters=[{"name": "ft", "checkpoint": "latest"}])
    assert _trial_id_for(config["serving"]) == \
        jax_trial_id_for(config["serving"]) == 5
    engine, batcher = build_replica(config)
    np.testing.assert_array_equal(
        engine.params["wte"].numpy(), params["wte"])
    assert _generate(batcher, model="ft") == _generate(_batcher(ft))


def test_compile_prepares_the_sampler_as_the_jax_engine_does(params,
                                                            monkeypatch):
    jeng = JaxEngine(jax.tree_util.tree_map(np.asarray, params),
                     jgpt2.Config(**TINY, remat=False, attention_impl="dot"),
                     slots=2, max_seq_len=32, prefill_buckets=[8],
                     attention_impl="dense")
    jstats = jeng.compile()
    shapes = []
    real = smodel.sample

    def spy(logits, temperature, generator):
        shapes.append(tuple(logits.shape))
        return real(logits, temperature, generator)

    monkeypatch.setattr(smodel, "sample", spy)
    eng = ServingEngine(params, TCFG, slots=2, max_seq_len=32,
                        prefill_buckets=[8], kv_block_size=8, device="cpu")
    before = eng._generator.get_state()
    stats = eng.compile()
    assert "sample_s" in stats and "sample_s" in jstats
    assert shapes == [(2, TCFG.vocab_size), (1, TCFG.vocab_size)]
    assert torch.equal(eng._generator.get_state(), before)


def test_only_shared_fs_storage_is_read(tmp_path):
    assert checkpoint_base({"type": "shared_fs", "host_path": "/x",
                            "storage_path": "y"}) == "/x/y"
    with pytest.raises(NotImplementedError, match="'gcs'"):
        checkpoint_base({"type": "gcs", "bucket": "b"})


# ------------------------------------------------------- master-attached main


def test_main_attached_to_a_master_reports_and_drains(tmp_path, params):
    got = []

    class Master(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):  # noqa: N802
            n = int(self.headers.get("Content-Length", 0))
            got.append((self.path, json.loads(self.rfile.read(n) or b"null")))
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"{}")

    master = ThreadingHTTPServer(("127.0.0.1", 0), Master)
    threading.Thread(target=master.serve_forever, daemon=True).start()
    _save(tmp_path, params, 2)
    env = {k: v for k, v in os.environ.items() if not k.startswith("DET_")}
    env.update(PYTHONPATH=REPO, DET_ALLOCATION_ID="alloc-7",
               DET_MASTER=f"http://127.0.0.1:{master.server_address[1]}",
               DET_SERVING_CONFIG=json.dumps(_serve_config(
                   tmp_path, checkpoint="latest", heartbeat_period_s=0.2)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "determined_tpu_torch.serve"], cwd=REPO,
        env=env, stderr=subprocess.PIPE, text=True)
    try:
        port = None
        for line in proc.stderr:
            m = re.search(r"serve replica up on port (\d+)", line)
            if m:
                port = int(m.group(1))
                break
        assert port, "replica never came up"
        import urllib.request

        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/generate", method="POST",
            data=json.dumps({"tokens": PROMPT, "max_new_tokens": 3}).encode(),
            headers={"X-Request-Id": "rid-9"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200
        deadline = time.monotonic() + 30
        while not any(p.endswith("/serve_stats") for p, _ in got) and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stderr.close()
        master.shutdown()
    paths = [p for p, _ in got]
    alloc = "/api/v1/allocations/alloc-7"
    assert paths[:2] == [f"{alloc}/proxy_address", f"{alloc}/ready"]
    assert got[0][1]["address"].endswith(f":{port}")
    stats = [b for p, b in got if p == f"{alloc}/serve_stats"]
    assert stats and stats[-1]["draining"] is True  # the drain report
    spans = [s for p, b in got if p == f"{alloc}/request_spans"
             for s in b["spans"]]
    assert {s["name"] for s in spans if s["trace_id"] == "rid-9"} == {
        "serve.request", "serve.queue_wait", "serve.prefill", "serve.decode"}


def test_main_drains_on_the_preemption_signal(tmp_path, params):
    """The master answers the allocation's preemption long-poll once a
    request is in flight: the replica acks, reports draining, finishes
    that request and exits 0 without a SIGTERM."""
    got, polls = [], []
    armed = threading.Event()

    class Master(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _reply(self, body):
            data = json.dumps(body).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802 — the preemption long-poll
            polls.append(self.path)
            armed.wait(30)
            self._reply({"preempt": True, "deadline_seconds": 20,
                         "reason": "spot"} if armed.is_set() else {})

        def do_POST(self):  # noqa: N802
            n = int(self.headers.get("Content-Length", 0))
            got.append((self.path, json.loads(self.rfile.read(n) or b"null")))
            self._reply({})

    master = ThreadingHTTPServer(("127.0.0.1", 0), Master)
    threading.Thread(target=master.serve_forever, daemon=True).start()
    _save(tmp_path, params, 2)
    env = {k: v for k, v in os.environ.items() if not k.startswith("DET_")}
    env.update(PYTHONPATH=REPO, DET_ALLOCATION_ID="alloc-8",
               DET_MASTER=f"http://127.0.0.1:{master.server_address[1]}",
               DET_SERVING_CONFIG=json.dumps(_serve_config(
                   tmp_path, checkpoint="latest", heartbeat_period_s=30)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "determined_tpu_torch.serve"], cwd=REPO,
        env=env, stderr=subprocess.PIPE, text=True)
    result = {}
    try:
        port = None
        for line in proc.stderr:
            m = re.search(r"serve replica up on port (\d+)", line)
            if m:
                port = int(m.group(1))
                break
        assert port, "replica never came up"
        import urllib.request

        def generate():
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/generate", method="POST",
                data=json.dumps({"tokens": PROMPT,
                                 "max_new_tokens": 24}).encode())
            with urllib.request.urlopen(req, timeout=60) as resp:
                result["status"] = resp.status
                result["tokens"] = json.loads(resp.read())["tokens"]

        client = threading.Thread(target=generate)
        client.start()
        time.sleep(0.2)  # the request is accepted
        armed.set()
        assert proc.wait(timeout=60) == 0
        client.join(60)
    finally:
        armed.set()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stderr.close()
        master.shutdown()
    assert result["status"] == 200 and len(result["tokens"]) == 24
    alloc = "/api/v1/allocations/alloc-8"
    assert polls and all(p.startswith(f"{alloc}/signals/preemption")
                         for p in polls)
    paths = [p for p, _ in got]
    assert f"{alloc}/signals/ack_preemption" in paths
    stats = [b for p, b in got if p == f"{alloc}/serve_stats"]
    assert stats and stats[-1]["draining"] is True
