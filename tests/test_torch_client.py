"""The port's Python client against the JAX package's: every public call
of `Determined`, `Experiment`, `Trial`, `Checkpoint`, `Model`,
`ModelVersion`, the module functions, `Bindings` and `StreamClient` sends
the JAX counterpart's (method, path, params, body); `expconf.check` gives
the JAX config; `Checkpoint.download` of a port checkpoint from shared_fs
gives the files the port's storage wrote.

`RecordingMaster` (a stdlib HTTP server answering every route with one
canned body) is shared with tests/test_torch_cli.py."""

import base64
import copy
import glob
import inspect
import io
import json
import os
import tarfile
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch

from determined_tpu import expconf as jexpconf
from determined_tpu.common import bindings as jbindings
from determined_tpu.common import streams as jstreams
from determined_tpu.experimental import client as jclient
from determined_tpu_torch import expconf as texpconf
from determined_tpu_torch.common import bindings as tbindings
from determined_tpu_torch.common import streams as tstreams
from determined_tpu_torch.experimental import client as tclient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIENTS = {"jax": jclient, "port": tclient}

USER = {"id": 1, "username": "determined", "role": "admin", "active": True}
EXPERIMENT = {"id": 7, "name": "exp", "state": "COMPLETED", "progress": 1.0,
              "start_time": "2026-01-01T00:00:00Z", "archived": False,
              "config": {"searcher": {"smaller_is_better": False}}}
TRIALS = [
    {"id": 3, "experiment_id": 7, "state": "COMPLETED",
     "hparams": {"lr": 0.1}, "total_batches": 8, "restarts": 0,
     "latest_checkpoint": "ck-3", "searcher_metric_value": 0.25,
     "current_slots": 1},
    {"id": 4, "experiment_id": 7, "state": "COMPLETED",
     "hparams": {"lr": 0.2}, "total_batches": 4, "restarts": 1,
     "latest_checkpoint": "ck-4", "searcher_metric_value": 0.5,
     "current_slots": 1}]
MODEL_VERSION = {"id": 2, "version": 1, "checkpoint_uuid": "ck-4",
                 "source_experiment_id": 7, "source_trial_id": 4,
                 "steps_completed": 4, "creation_time": "t"}
SPANS = [{"span_id": "a", "parent": "", "name": "trial.lifecycle",
          "start_us": 0, "end_us": 5000},
         {"span_id": "b", "parent": "a", "name": "harness.compile",
          "start_us": 1000, "end_us": 3000}]


def canned(storage):
    """One body for every route: each key a command or client call
    reads, lists with rows holding every column printed."""
    checkpoint = {"uuid": "ck-4", "trial_id": 4, "steps_completed": 4,
                  "state": "COMPLETED", "report_time": "t",
                  "metadata": {"k": 1}, "resources": {"f": 3},
                  "experiment_config": {"checkpoint_storage": {
                      "type": "shared_fs", "host_path": storage}}}
    task = {"id": "cmd-1", "type": "COMMAND", "state": "ACTIVE",
            "allocation_state": "RUNNING", "start_time": "t",
            "end_time": None, "proxy_address": "http://h:1"}
    latency = {k: {"count": 2, "p50_ms": 1.0, "p99_ms": 2.0}
               for k in ("ttft", "tpot", "e2e")}
    deployment = {"id": "deploy-1", "name": "d", "state": "ACTIVE",
                  "replica_count": 1, "target_replicas": 2,
                  "min_replicas": 1, "max_replicas": 3,
                  "model_version": "checkpoint:ck-4", "swapping": True,
                  "canary": {"version": "m:2", "fraction": 0.1,
                             "observed_fraction": 0.09},
                  "smoothed_load": 0.5, "latency": latency,
                  "latency_by_version": {"m:1": latency, "m:2": latency}}
    return {
        "token": "tok", "id": "7", "allocation_id": "alloc-1",
        "user": USER, "users": [USER, {"id": 2, "username": "bob",
                                       "role": "user", "active": True}],
        "experiment": EXPERIMENT, "experiments": [EXPERIMENT],
        "trial": TRIALS[0], "trials": TRIALS,
        "checkpoint": checkpoint, "checkpoints": [checkpoint],
        "model": {"id": 5, "name": "m", "description": "d",
                  "metadata": {}, "archived": False},
        "models": [{"id": 5, "name": "m", "description": "d",
                    "archived": False}],
        "model_version": MODEL_VERSION, "model_versions": [MODEL_VERSION],
        "metrics": [{"group": "training", "steps_completed": 4,
                     "metrics": {"loss": 1.5}}],
        "agents": [{"id": "agent-0", "resource_pool": "default",
                    "alive": True, "state": "DRAINING",
                    "drain_reason": "spot", "preemptible": True,
                    "slots": [{"allocation_id": "a"}, {}]}],
        "tasks": [task], "commands": [task], "notebooks": [task],
        "shells": [task], "tensorboards": [task], "task": task,
        "jobs": [{"allocation_id": "a", "experiment_id": 7,
                  "state": "QUEUED", "slots": 1, "priority": 42,
                  "signature": "0123456789abcdef0123", "agent_id": "x",
                  "attempts": 1, "compile_ms": 12.3456}],
        "assignments": [{"id": 1, "role": "viewer", "username": "u",
                         "group_name": "", "workspace_id": 1}],
        "groups": [{"id": 1, "name": "g",
                    "members": [{"username": "u"}, {"username": "v"}]}],
        "workspaces": [{"id": 1, "name": "w", "archived": False}],
        "projects": [{"id": 1, "name": "p", "workspace_id": 1,
                      "archived": False}],
        "templates": [{"name": "t"}],
        "deployments": [deployment], "deployment": deployment,
        "serving": [{"id": "serve-1", "state": "ACTIVE",
                     "allocation_state": "RUNNING",
                     "proxy_address": "http://h:2", "restarts": 0}],
        "target": 2, "replicas": ["r-1", "r-2"], "rolling": True,
        "checkpoint_id": "ck-4", "canary_stats": {"routed": 3,
                                                  "routed_stable": 9},
        "promoted": "m:2", "aborted": "m:2", "canary": "m:2",
        "fraction": 0.1, "spans": SPANS, "trace_id": "tr",
        "deployment_id": "deploy-1", "events": [], "dropped": False,
        "master_id": "m-1", "version": "x"}


def _normalised(body):
    """A request body with any tarred context decoded into its files:
    gzip stamps the time into the archive."""
    if not isinstance(body, dict):
        return body
    out = dict(body)
    for key in ("model_definition", "context"):
        if out.get(key):
            raw = base64.b64decode(out[key])
            with tarfile.open(fileobj=io.BytesIO(raw), mode="r:gz") as tar:
                out[key] = sorted((m.name, tar.extractfile(m).read())
                                  for m in tar.getmembers() if m.isfile())
    return out


class RecordingMaster:
    """A stdlib HTTP master recording (method, path, query, body) and
    answering `body_for(method, path, query)` (default: `canned`). Task
    logs page: the first page has one line, later ones none."""

    def __init__(self, storage="/nonexistent", body_for=None):
        self.requests = []
        self.body = canned(storage)
        self.body_for = body_for
        master = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _answer(self):
                url = urllib.parse.urlsplit(self.path)
                query = dict(urllib.parse.parse_qsl(url.query))
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n)) if n else None
                master.requests.append((self.command, url.path, query,
                                        _normalised(body)))
                out = master.answer(self.command, url.path, query)
                data = json.dumps(out).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            do_GET = do_POST = do_PATCH = do_DELETE = _answer

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self._server.server_address[1]}"
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()

    def answer(self, method, path, query):
        if self.body_for is not None:
            return self.body_for(method, path, query)
        out = dict(self.body)
        if path.endswith("/logs"):
            first = int(query.get("offset", 0)) == 0
            out["logs"] = [{"id": 1, "log": "a log line"}] if first else []
        return out

    def take(self):
        out, self.requests = self.requests, []
        return out

    def close(self):
        self._server.shutdown()
        self._server.server_close()


@pytest.fixture()
def master(tmp_path):
    m = RecordingMaster(str(tmp_path / "storage"))
    yield m
    m.close()


class _StubSession:
    def __init__(self, log):
        self.log = log

    def __getattr__(self, verb):
        def call(*args, **kwargs):
            self.log.append((verb, args, kwargs))
            return {"ok": verb}
        return call


def test_bindings_are_the_generated_bindings_over_the_port_session():
    def body(module):
        with open(module.__file__) as f:
            text = f.read()
        return text[text.index("class Bindings"):]

    # The same generated file, over the port's Session.
    assert body(tbindings) == body(jbindings)
    with open(tbindings.__file__) as f:
        assert "from determined_tpu_torch.common.api import Session" in \
            f.read()
    names = [n for n, _ in inspect.getmembers(jbindings.Bindings,
                                              inspect.isfunction)
             if not n.startswith("_")]
    assert len(names) > 100
    assert names == [n for n, _ in inspect.getmembers(
        tbindings.Bindings, inspect.isfunction) if not n.startswith("_")]
    for name in names:
        sig = inspect.signature(getattr(jbindings.Bindings, name))
        args = [f"p{i}" for i, p in enumerate(list(sig.parameters.values())
                                              [1:])
                if p.kind == p.POSITIONAL_OR_KEYWORD]
        kwargs = {k: v for k, v in (("params", {"q": 1}),
                                    ("body", {"b": [1, 2]}),
                                    ("timeout", 5.0))
                  if k in sig.parameters}
        logs = {}
        for k, mod in (("jax", jbindings), ("port", tbindings)):
            logs[k] = []
            out = getattr(mod.Bindings(_StubSession(logs[k])), name)(
                *args, **kwargs)
            assert out == {"ok": logs[k][0][0]}
        assert logs["port"] == logs["jax"], name


def test_stream_client_sends_what_the_jax_one_sends():
    batches = [{"events": [{"seq": 4, "entity": "experiments"}]},
               {"events": [], "dropped": True},
               {"events": [{"seq": 9, "entity": "resync"},
                           {"seq": 10, "entity": "trials"}]}]
    seen = {}
    for k, mod in (("jax", jstreams), ("port", tstreams)):
        class Session:
            def __init__(self):
                self.calls, self.left = [], copy.deepcopy(batches)

            def get(self, path, params=None):
                self.calls.append((path, params))
                return self.left.pop(0)

        s = Session()
        c = mod.StreamClient(s, since=2)
        first = c.poll(["experiments", "trials"], timeout_seconds=3.0)
        state = [(c.since, c.dropped)]
        sub = c.subscribe(None, timeout_seconds=1.0)
        rest = [next(sub), next(sub)]
        state.append((c.since, c.dropped))
        seen[k] = (s.calls, first, rest, state)
    assert seen["port"] == seen["jax"]
    assert seen["port"][3] == [(4, False), (10, True)]


def _sdk_calls(client_mod, master, model_dir, download_to):
    """Every public call of the SDK, in one order -> the values each
    returned (the requests are on the master)."""
    out = []
    d = client_mod.Determined(master.url, user="u", password="pw")
    exp = d.create_experiment(
        {"name": "e", "entrypoint": "python3 train.py",
         "searcher": {"name": "single", "metric": "loss",
                      "max_length": 8},
         "hyperparameters": {"lr": 0.1}}, model_dir, activate=False,
        project_id=2)
    out.append((exp.id, exp.state, exp.config, exp.progress, exp.archived))
    for verb in ("activate", "pause", "cancel", "kill", "archive",
                 "delete"):
        getattr(exp, verb)()
    out.append(exp.reload().state)
    out.append([(t.id, t.hparams, t.total_batches, t.restarts,
                 t.latest_checkpoint, t.searcher_metric_value)
                for t in exp.get_trials()])
    out.append(exp.await_first_trial(timeout=5).id)
    out.append(exp.wait(timeout=5, interval=0.01))
    ckpt = exp.top_checkpoint()
    out.append((ckpt.uuid, ckpt.trial_id, ckpt.steps_completed, ckpt.state,
                ckpt.metadata, ckpt.resources))
    out.append(ckpt.uuid == exp.top_checkpoint(smaller_is_better=True).uuid)
    out.append(ckpt.download(download_to) == download_to)
    ckpt.delete()
    out.append(d.get_experiment(7).id)
    out.append([e.id for e in d.list_experiments()])
    trial = d.get_trial(3)
    out.append(trial.reload().state)
    out.append(list(trial.iter_metrics("validation")))
    out.append(trial.top_checkpoint().uuid)
    out.append(list(trial.logs()))
    out.append(d.get_checkpoint("ck-4").uuid)
    model = d.create_model("m", description="d")
    out.append((model.name, model.id, model.description, model.metadata))
    version = model.register_version("ck-4")
    out.append((version.model_name, version.version,
                version.checkpoint_uuid))
    out.append([v.version for v in model.get_versions()])
    out.append(version.get_checkpoint().uuid)
    out.append(d.get_model("m").name)
    out.append([m.name for m in d.get_models()])
    out.append(d.get_agents()[0]["id"])
    out.append(d.get_master_info()["master_id"])
    client_mod.login(master.url, user="v", password="")
    out.append(client_mod.create_experiment(
        {"entrypoint": "x", "searcher": {"name": "single",
                                         "metric": "loss",
                                         "max_length": 1}}).id)
    return out


def test_every_sdk_call_sends_what_the_jax_client_sends(master, tmp_path,
                                                        monkeypatch):
    model_dir = tmp_path / "model_def"
    (model_dir / "pkg").mkdir(parents=True)
    (model_dir / "train.py").write_text("print('train')\n")
    (model_dir / "pkg" / "data.bin").write_bytes(bytes(range(256)))
    (model_dir / "__pycache__").mkdir()
    (model_dir / "__pycache__" / "x.pyc").write_bytes(b"skip")
    store = tmp_path / "storage" / "ck-4"
    store.mkdir(parents=True)
    (store / "state.pt").write_bytes(b"weights")
    sent, returned = {}, {}
    for k, mod in CLIENTS.items():
        monkeypatch.setattr(mod, "_default_client", None)
        returned[k] = _sdk_calls(mod, master, str(model_dir),
                                 str(tmp_path / f"download-{k}"))
        sent[k] = master.take()
    assert returned["port"] == returned["jax"]
    for k in CLIENTS:
        assert open(tmp_path / f"download-{k}" / "state.pt", "rb").read() \
            == b"weights"
    assert sent["port"] == sent["jax"]
    create = [b for m, p, q, b in sent["port"] if p == "/api/v1/experiments"
              and m == "POST"][0]
    assert create["model_definition"] == [("pkg/data.bin", bytes(range(256))),
                                          ("train.py", b"print('train')\n")]
    assert (create["activate"], create["project_id"]) == (False, 2)
    assert len(sent["port"]) > 30


@pytest.mark.parametrize("name", ["examples/mnist_cuda/adaptive.yaml",
                                  "examples/gpt2_cuda/long_context.yaml"])
def test_expconf_check_gives_the_jax_config(name):
    import yaml

    configs = [yaml.safe_load(open(os.path.join(REPO, name)))]
    configs += [yaml.safe_load(open(p)) for p in sorted(glob.glob(
        os.path.join(REPO, "examples", "*_cuda", "*.yaml")))]
    configs.append({"entrypoint": "x", "searcher": {
        "name": "custom", "metric": "samples_per_second",
        "smaller_is_better": False}, "resources": {"slots": 2},
        "min_validation_period": 5, "optimizations": {
            "attention_impl": "auto", "aggregation_frequency": 2}})
    for config in configs:
        assert texpconf.check(copy.deepcopy(config)) == \
            jexpconf.check(copy.deepcopy(config))
    bad = {"searcher": {"name": "nope"}, "hyperparameters": {
        "mesh": {"data": 3, "bogus": 2}}}
    errors = {}
    for k, mod in (("jax", jexpconf), ("port", texpconf)):
        with pytest.raises(ValueError) as e:
            mod.check(copy.deepcopy(bad))
        errors[k] = str(e.value)
    assert errors["port"] == errors["jax"]
    assert texpconf.merge({"a": {"b": 1}}, {"a": {"c": 2}, "d": [1]}) == \
        jexpconf.merge({"a": {"b": 1}}, {"a": {"c": 2}, "d": [1]})


def test_checkpoint_download_gives_the_files_the_port_storage_wrote(
        tmp_path):
    from determined_tpu_torch.core._checkpoint import CheckpointContext

    storage = tmp_path / "storage"
    ctx = CheckpointContext(str(storage), trial_id=3)
    state = {"params": {"w": torch.arange(12.0).reshape(3, 4)},
             "step": 5}
    ctx.save_state(state, 5)
    ctx.close()
    [sid] = os.listdir(storage)
    wrote = {os.path.relpath(os.path.join(r, f), storage / sid):
             open(os.path.join(r, f), "rb").read()
             for r, _, fs in os.walk(storage / sid) for f in fs}
    assert any(name.endswith(".pt") for name in wrote)
    data = {"uuid": sid, "trial_id": 3, "experiment_config": {
        "checkpoint_storage": {"type": "shared_fs",
                               "host_path": str(storage)}}}
    for k, mod in CLIENTS.items():
        dst = str(tmp_path / f"download-{k}")
        assert mod.Checkpoint(None, data).download(dst) == dst
        got = {os.path.relpath(os.path.join(r, f), dst):
               open(os.path.join(r, f), "rb").read()
               for r, _, fs in os.walk(dst) for f in fs}
        assert got == wrote, k
    restored = CheckpointContext(str(tmp_path / "download-port" / ".."),
                                 trial_id=3)
    params = restored.restore_params("download-port")
    assert torch.equal(params["w"], state["params"]["w"])
