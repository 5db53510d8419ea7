"""Managed-mode core against the JAX package's, through one fake master.

The same `DET_*` environment and the same calls go through
`determined_tpu.core.init` and `determined_tpu_torch.core.init`, each
against a recording stdlib master. The recorded (method, path, query,
body, X-Allocation-Epoch, Authorization, idempotency key present)
sequences must be equal. What differs by nature is normalised away, and
only that: wall-clock times, span ids, the state files of a checkpoint
(orbax shards against `state/state.pt`: the resources are compared by the
protocol files present) and the metadata's `format`. The preemption
watcher's long-polls run on their own thread and are compared as a set.

Both packages' tfevents writer is replaced by `ScalarRecorder`, which
keeps the scalars as JSON in the log directory (`torch.utils.tensorboard`
would pull in TensorFlow on a CPU host): the per-trial tensorboard
managers must put the same scalars there and sync them into the same
place in storage.

Then `ClusterInfo` field by field against the JAX one for several
environments, and the two refusals: a multi-host rendezvous and a
checkpoint storage other than `shared_fs`.
"""

import dataclasses
import json
import os
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax.numpy as jnp
import pytest
import torch

from determined_tpu import _info as jinfo
from determined_tpu import core as jcore
from determined_tpu import tensorboard as jtensorboard
from determined_tpu.experimental import core_v2 as jcore_v2
from determined_tpu_torch import _info as tinfo
from determined_tpu_torch import core as tcore
from determined_tpu_torch import tensorboard as ttensorboard
from determined_tpu_torch.experimental import core_v2 as tcore_v2

PREEMPTION = "/signals/preemption"


class ScalarRecorder:
    """Stands in for both packages' tfevents `MetricWriter`: keeps the
    scalars and writes them to `scalars.json` in the log directory at each
    flush, so the manager's sync carries them into storage."""

    def __init__(self, log_dir):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.scalars = []

    def add_scalars(self, metrics, step, prefix=""):
        self.scalars += [[f"{prefix}{k}", float(v), step]
                         for k, v in metrics.items()]

    def flush(self):
        with open(os.path.join(self.log_dir, "scalars.json"), "w") as f:
            json.dump(self.scalars, f)

    def close(self):
        pass


@pytest.fixture(autouse=True)
def _scalar_recorder(monkeypatch):
    monkeypatch.setattr(jtensorboard, "MetricWriter", ScalarRecorder)
    monkeypatch.setattr(ttensorboard, "MetricWriter", ScalarRecorder)


@pytest.fixture(autouse=True)
def _jax_cluster_info_follows_the_env():
    """The JAX package caches its ClusterInfo: after this file's tests set
    and restore `DET_*` variables, reload it from the restored environment
    so no later test in the process sees a stale master."""
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)
    jinfo.get_cluster_info(refresh=True)


class FakeMaster:
    """Records every request; answers from `script` (path -> callable of
    (query, body) -> JSON value). The preemption long-poll is held until
    `preempt()`."""

    def __init__(self, script=None):
        self.requests = []
        self.polls = []
        self.script = dict(script or {})
        self.signal = None
        self._armed = threading.Event()
        master = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _answer(self):
                url = urllib.parse.urlsplit(self.path)
                query = dict(urllib.parse.parse_qsl(url.query))
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n) if n else b""
                body = json.loads(raw) if raw else None
                rec = (self.command, url.path, tuple(sorted(query.items())),
                       body, self.headers.get("X-Allocation-Epoch"),
                       self.headers.get("Authorization"),
                       "X-Idempotency-Key" in self.headers)
                if url.path.endswith(PREEMPTION):
                    master.polls.append(rec)
                    master._armed.wait(
                        min(float(query.get("timeout_seconds", 1)), 30.0))
                    out = master.signal if master._armed.is_set() else {}
                else:
                    master.requests.append(rec)
                    fn = master.script.get(url.path)
                    out = fn(query, body) if fn else {}
                data = json.dumps(out).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            do_GET = do_POST = do_PATCH = do_DELETE = _answer

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self._server.server_address[1]}"
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()

    def preempt(self, signal):
        self.signal = signal
        self._armed.set()

    def close(self):
        self._armed.set()
        self._server.shutdown()
        self._server.server_close()


def _normalise(rec):
    method, path, query, body, epoch, auth, idem = rec
    if isinstance(body, dict):
        body = json.loads(json.dumps(body))
        body.pop("report_time", None)
        md = body.get("metadata")
        if isinstance(md, dict):
            md.pop("time", None)
            md.pop("format", None)
        if "resources" in body:
            body["resources"] = sorted(
                {"metadata.json", "manifest.json", "COMMIT"}
                & set(body["resources"]))
        for sp in body.get("spans", []):
            assert sp["end_us"] >= sp["start_us"] > 0
            sp["parent_is_root"] = sp.pop("parent") == sp["trace_id"]
            for k in ("span_id", "start_us", "end_us"):
                sp.pop(k)
    return (method, path, query, body, epoch, auth, idem)


@pytest.fixture
def cluster_env(monkeypatch, tmp_path):
    """A clean DET_* environment; yields a setter."""
    for k in [k for k in os.environ if k.startswith("DET_")]:
        monkeypatch.delenv(k)

    def set_env(master, **extra):
        env = {
            "DET_MASTER": master.url, "DET_TRIAL_ID": "3",
            "DET_EXPERIMENT_ID": "2", "DET_ALLOCATION_ID": "alloc-1",
            "DET_ALLOCATION_EPOCH": "4", "DET_SESSION_TOKEN": "tok",
            "DET_TRIAL_RUN_ID": "1", "DET_TRACE_ID": "feedfacecafe0001",
            "DET_HPARAMS": json.dumps({"lr": 0.1}),
            "DET_EXPERIMENT_CONFIG": json.dumps({"checkpoint_storage": {
                "type": "shared_fs", "host_path": str(tmp_path)}}),
            **extra}
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        jinfo.get_cluster_info(refresh=True)  # the JAX package caches it

    return set_env


def _searcher_script(ops):
    """Answers the op long-poll: the next length after `last`, then done."""
    def next_op(query, body):
        later = [n for n in ops if n > int(query["last"])]
        return {"op": {"length": later[0]}} if later else {"done": True}
    return next_op


class StillClock:
    """`time` for both packages' preemption modules: `monotonic()` stands
    still until the test moves it (`now`), so the grace a deadline read
    reports does not depend on how long a loaded host took to get there;
    everything else is the real module's."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


def _drive_trial(core_mod, state, master, preempt_signal, clock):
    """The managed calls of one trial process, as a Trainer makes them."""
    ctx = core_mod.init(max_length=None)
    assert ctx.hparams == {"lr": 0.1} and ctx.latest_checkpoint is None
    ctx.searcher._poll_interval = 0.01
    ops = []
    for op in ctx.searcher.operations():
        ops.append(op.length)
        ctx.train.report_training_metrics(op.length, {"loss": 1.0 / op.length})
        ctx.train.report_progress(op.length / 4)
        with ctx.tracer.span("harness.validate", step=op.length):
            ctx.train.report_validation_metrics(
                op.length, {"validation_loss": 2.0})
        ctx.checkpoint.save_state(state, op.length)
        ctx.checkpoint.wait()
        op.report_completed(0.25)
    ctx.train.set_status("RUNNING")
    ctx.tracer.flush()
    lineage = ctx.checkpoint.lineage()
    master.preempt(preempt_signal)
    deadline = time.monotonic() + 30
    while not ctx.preempt.should_preempt(auto_ack=False):
        assert time.monotonic() < deadline, "no preemption signal"
        time.sleep(0.01)
    ctx.preempt.should_preempt()  # acks
    clock.now += 2.0  # two seconds of the grace pass
    seen = (ctx.preempt.preemption_deadline(),
            ctx.preempt.preemption_reason(), ctx.preempt.resize_target())
    ctx.close()
    return ops, lineage, seen


def test_a_trial_sends_what_the_jax_core_sends(cluster_env, tmp_path,
                                              monkeypatch):
    from determined_tpu.core import _preempt as jpreempt
    from determined_tpu_torch.core import _preempt as tpreempt

    signal = {"preempt": True, "deadline_seconds": 60, "reason": "spot",
              "resize": True, "target_slots": 4}
    runs = {}
    for name, core_mod, state in (
            ("jax", jcore, {"w": jnp.arange(4.0)}),
            ("torch", tcore, {"w": torch.arange(4.0)})):
        master = FakeMaster({
            "/api/v1/trials/3/searcher/operation": _searcher_script([2, 4]),
            "/api/v1/trials/3/checkpoints": lambda q, b: {"checkpoints": [
                {"uuid": "trial3-step4"}, {"uuid": "trial3-step2"}]}})
        # One storage directory each: the two must not share checkpoints.
        cluster_env(master, DET_EXPERIMENT_CONFIG=json.dumps(
            {"checkpoint_storage": {"type": "shared_fs",
                                    "host_path": str(tmp_path / name)}}))
        clock = StillClock()
        monkeypatch.setattr(jpreempt, "time", clock)
        monkeypatch.setattr(tpreempt, "time", clock)
        try:
            runs[name] = _drive_trial(core_mod, state, master, signal, clock)
        finally:
            master.close()
        with open(tmp_path / name / "tensorboard" / "2" / "3" /
                  "scalars.json") as f:
            synced = json.load(f)
        runs[name] += ([_normalise(r) for r in master.requests],
                       {_normalise(r) for r in master.polls}, synced)
    (j_ops, j_lin, j_seen, j_req, j_polls, j_tb) = runs["jax"]
    (t_ops, t_lin, t_seen, t_req, t_polls, t_tb) = runs["torch"]
    assert t_tb == j_tb == [
        ["training/loss", 0.5, 2], ["validation/validation_loss", 2.0, 2],
        ["training/loss", 0.25, 4], ["validation/validation_loss", 2.0, 4]]
    assert t_ops == j_ops == [2, 4]
    assert t_lin == j_lin == ["trial3-step4", "trial3-step2"]
    assert t_seen[1:] == j_seen[1:] == ("spot", 4)
    assert t_seen[0] == j_seen[0] == 58.0  # 60 s of grace, 2 s gone
    assert t_req == j_req
    assert t_polls == j_polls == {
        ("GET", "/api/v1/allocations/alloc-1/signals/preemption",
         (("timeout_seconds", "60"),), None, "4", "Bearer tok", False)}
    paths = [r[1] for r in t_req]
    assert paths[0] == "/api/v1/trials/3/run_prepare"
    assert "/api/v1/allocations/alloc-1/signals/ack_preemption" in paths
    reports = [r[3] for r in t_req if r[1] == "/api/v1/checkpoints"]
    assert [(c["uuid"], c["state"], c["resources"]) for c in reports] == [
        ("trial3-step2", "PARTIAL", ["metadata.json"]),
        ("trial3-step2", "COMPLETED",
         ["COMMIT", "manifest.json", "metadata.json"]),
        ("trial3-step4", "PARTIAL", ["metadata.json"]),
        ("trial3-step4", "COMPLETED",
         ["COMMIT", "manifest.json", "metadata.json"])]
    spans = [s["name"] for r in t_req if r[1].endswith("/spans")
             for s in r[3]["spans"]]
    assert spans.count("harness.checkpoint.commit") == 2
    assert "harness.validate" in spans
    done = [r[3] for r in t_req if r[1].endswith("/completed_operation")]
    assert done == [{"length": 2, "searcher_metric": 0.25},
                    {"length": 4, "searcher_metric": 0.25}]


@pytest.mark.parametrize("answer", [{"done": True}, {}],
                         ids=["done", "idle"])
def test_the_searcher_stops_as_the_jax_one_does(cluster_env, answer):
    """No op at all: `done` closes the trial, and an empty answer past the
    idle grace frees the device; both without a completed op."""
    seqs = {}
    for name, core_mod in (("jax", jcore), ("torch", tcore)):
        master = FakeMaster({"/api/v1/trials/3/searcher/operation":
                             lambda q, b: answer})
        cluster_env(master, DET_ALLOCATION_ID="")
        try:
            ctx = core_mod.init()
            ctx.searcher._idle_grace = 0.0
            assert list(ctx.searcher.operations()) == []
            ctx.close()
        finally:
            master.close()
        seqs[name] = [_normalise(r) for r in master.requests]
    assert seqs["torch"] == seqs["jax"]
    assert [r[1] for r in seqs["torch"]] == [
        "/api/v1/trials/3/run_prepare",
        "/api/v1/trials/3/searcher/operation"]
    assert seqs["torch"][1][2] == (("last", "0"), ("timeout_seconds", "10"))


def test_core_v2_registers_reports_and_completes(tmp_path, monkeypatch):
    for k in [k for k in os.environ if k.startswith("DET_")]:
        monkeypatch.delenv(k)
    seqs = {}
    for name, mod in (("jax", jcore_v2), ("torch", tcore_v2)):
        master = FakeMaster({
            "/api/v1/auth/login": lambda q, b: {"token": "t0"},
            "/api/v1/experiments": lambda q, b: {"id": 9},
            "/api/v1/experiments/9/trials": lambda q, b: {"id": 11}})
        try:
            ctx = mod.init(config={"name": "run"}, master=master.url,
                           password="pw", hparams={"lr": 0.5},
                           max_length=3,
                           checkpoint_storage={"type": "shared_fs",
                                               "host_path": str(tmp_path)})
            assert (ctx.experiment_id, ctx.trial_id) == (9, 11)
            mod.train.report_training_metrics(1, {"loss": 0.5})
            assert [op.length for op in mod.searcher.operations()] == [3]
            mod.close()
        finally:
            master.close()
        seqs[name] = [_normalise(r) for r in master.requests]
    assert seqs["torch"] == seqs["jax"]
    assert [r[1] for r in seqs["torch"]] == [
        "/api/v1/auth/login", "/api/v1/experiments",
        "/api/v1/experiments/9/trials", "/api/v1/trials/11/metrics",
        "/api/v1/experiments/9/complete"]
    with pytest.raises(RuntimeError, match="init"):
        tcore_v2.train.report_training_metrics(1, {})


@pytest.mark.parametrize("env", [
    {},
    {"DET_MASTER": "http://m:8080"},
    {"DET_MASTER": "http://m:8080", "DET_TRIAL_ID": "5",
     "DET_EXPERIMENT_ID": "2", "DET_TRIAL_SEED": "17",
     "DET_HPARAMS": '{"a": 1}', "DET_EXPERIMENT_CONFIG": '{"b": [2]}',
     "DET_STEPS_COMPLETED": "30", "DET_LATEST_CHECKPOINT": "trial5-step30",
     "DET_TRIAL_RUN_ID": "3", "DET_ALLOCATION_ID": "a.1",
     "DET_ALLOCATION_EPOCH": "7", "DET_SESSION_TOKEN": "s",
     "DET_TASK_ID": "t", "DET_AGENT_ID": "agent-0", "DET_CLUSTER_ID": "c"},
    {"DET_MASTER": "https://m", "DET_CONTAINER_ADDRS": "10.0.0.1,10.0.0.2",
     "DET_CONTAINER_RANK": "1", "DET_SLOT_IDS": "0,1",
     "DET_COORDINATOR_ADDR": "10.0.0.1:8476", "DET_TPU_WORKER_ID": "1",
     "DET_MESH_CONFIG": '{"data": 2}', "DET_ALLOCATION_EPOCH": ""},
    {"DET_MASTER": "http://m", "DET_RUN_DIR": "RUN_DIR"},
], ids=["local", "master-only", "trial", "rendezvous-env", "rendezvous-file"])
def test_cluster_info_reads_the_environment_as_jax_does(
        monkeypatch, tmp_path, env):
    for k in [k for k in os.environ if k.startswith("DET_")]:
        monkeypatch.delenv(k)
    if env.get("DET_RUN_DIR") == "RUN_DIR":
        os.makedirs(tmp_path / "info")
        (tmp_path / "info" / "rendezvous.json").write_text(json.dumps({
            "container_addrs": ["h0", "h1", "h2"], "container_rank": 2,
            "slot_ids": [3], "coordinator_addr": "h0:1"}))
        env = dict(env, DET_RUN_DIR=str(tmp_path))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ours = tinfo.get_cluster_info()
    theirs = jinfo.get_cluster_info(refresh=True)
    assert (ours is None) == (theirs is None) == (not env)
    if ours is not None:
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.task_container_rank == theirs.task_container_rank


def test_a_multi_host_rendezvous_is_refused(cluster_env):
    # A rendezvous of two hosts forms a process group (DistributedContext.
    # from_allocation); its data plane is NCCL unless DET_TORCH_BACKEND
    # names gloo, so on a host without CUDA it is refused, never run as
    # one local process.
    master = FakeMaster()
    cluster_env(master, DET_CONTAINER_ADDRS="10.0.0.1,10.0.0.2")
    try:
        with pytest.raises(RuntimeError, match="nccl backend needs a CUDA"):
            tcore.init()
    finally:
        master.close()
    assert master.requests == []  # refused before it spoke to the master


# Every storage type is ported now: a type is refused only for what it
# lacks (its SDK, its container), named, before init speaks to the master.
@pytest.mark.parametrize("stype", ["gcs", "s3", "azure", "directory"])
def test_storage_other_than_shared_fs_is_refused(cluster_env, monkeypatch,
                                                 stype, tmp_path):
    from determined_tpu_torch.storage import cloud
    from determined_tpu_torch.storage.base import DirectoryStorageManager

    # The tensorboard sync's uploads are recorded, never sent: no SDK call
    # may reach a real bucket.
    synced = []
    monkeypatch.setattr(cloud.GCSStorageManager, "upload",
                        lambda self, src, sid, paths=None: synced.append(sid))
    master = FakeMaster()
    cluster_env(master, DET_ALLOCATION_ID="")
    monkeypatch.setenv("DET_EXPERIMENT_CONFIG", json.dumps(
        {"checkpoint_storage": {"type": stype, "bucket": "b",
                                "container_path": str(tmp_path)}}))
    try:
        if stype in ("s3", "azure"):
            missing = {"s3": "boto3", "azure": "container"}[stype]
            with pytest.raises((RuntimeError, ValueError), match=missing):
                tcore.init()
            assert master.requests == []
            return
        ctx = tcore.init()
        want = {"gcs": cloud.GCSStorageManager,
                "directory": DirectoryStorageManager}[stype]
        assert isinstance(ctx.checkpoint._storage, want)
        ctx.close()
        if stype == "gcs":
            assert synced and set(synced) == {
                ttensorboard.storage_prefix(2, 3)}, synced
    finally:
        master.close()
