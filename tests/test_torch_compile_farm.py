"""The port's compile farm (docs/compile-farm-torch.md) against the JAX
package's, on the CPU.

- `config_signature` and `canonical_hparams` give the JAX functions'
  strings and hashes, with bucketing on and off.
- `FarmClient` fetches, uploads, saves locally, turns into no-ops without a
  signature and never raises on a dead session, against a copy of the
  `_FakeSession` of tests/test_compile_farm.py.
- `ops/_build.py` resolves a library from disk, then the farm, then nvcc,
  with a fake `nvcc` (a script under a temporary CUDA_HOME that copies a
  loadable shared object to its `-o`, and logs each call): a warm hit makes
  no nvcc call and reads `build_seconds` 0.0, a bad artifact is rebuilt
  (and raises where nvcc fails), a fresh build is uploaded.
- `run_job` sends a recording fake master the JAX worker's requests, in
  the JAX worker's order, with the same body keys, and links on an equal
  fingerprint.
- The Trainer's first flush and `harness.compile` span carry the JAX
  Trainer's keys.
"""

import base64
import concurrent.futures
import ctypes
import os
import stat

import _ctypes
import numpy as np
import pytest
import test_torch_bucketing_trainer as tb

from determined_tpu.compile import signature as jsig
from determined_tpu.compile.bucketing import CompileConfig as JCompileConfig
from determined_tpu.compile.runtime import FarmClient as JFarmClient
from determined_tpu_torch.compile import signature as tsig
from determined_tpu_torch.compile.bucketing import CompileConfig
from determined_tpu_torch.compile.runtime import FarmClient
from determined_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FIXTURES = os.path.join(REPO, "tests", "fixtures", "compile_farm")
TORCH_FIXTURES = os.path.join(REPO, "tests", "fixtures", "compile_farm_torch")


class _FakeSession:
    """Capture FarmClient round-trips without a master (a copy of
    tests/test_compile_farm.py's)."""

    def __init__(self):
        self.store = {}  # signature -> {name: bytes}
        self.posts = []

    def get(self, path, params=None, **kw):
        sig = path.rsplit("/", 1)[-1]
        files = self.store.get(sig, {})
        name = (params or {}).get("name")
        return {"signature": sig, "files": [
            {"name": n, "b64": base64.b64encode(b).decode(), "size": len(b)}
            for n, b in files.items() if name is None or n == name]}

    def post(self, path, body=None, **kw):
        self.posts.append((path, body))
        if "/compile_cache/" in path:
            sig = path.rsplit("/", 1)[-1]
            dest = self.store.setdefault(sig, {})
            for n, b64 in (body or {}).get("files", {}).items():
                dest[n] = base64.b64decode(b64)
        return {}


class _DeadSession:
    def get(self, *a, **kw):
        raise ConnectionError("master unreachable")

    post = get


HPARAMS = [
    {"lr": 0.01, "global_batch_size": 6},
    {"global_batch_size": 100, "mesh": {"data": 2}, "name": "x",
     "flag": True, "warmup": [1, 2.5]},
    {},
]


@pytest.mark.parametrize("bucketed", [False, True])
def test_signatures_are_the_jax_packages(bucketed):
    for hp in HPARAMS:
        cfgs = (CompileConfig(bucket_batch_sizes=bucketed),
                JCompileConfig(bucket_batch_sizes=bucketed))
        assert tsig.canonical_hparams(hp, cfgs[0]) == \
            jsig.canonical_hparams(hp, cfgs[1])
        for ep in ("python3 train.py", ["python3", "-m", "x"]):
            assert tsig.config_signature(hp, ep, "abc123", 4, cfgs[0]) == \
                jsig.config_signature(hp, ep, "abc123", 4, cfgs[1])
    # Bucketing folds 6 into 8: one signature for both sizes.
    cfg = CompileConfig(bucket_batch_sizes=bucketed)
    assert (tsig.config_signature({"global_batch_size": 6}, cfg=cfg) ==
            tsig.config_signature({"global_batch_size": 8}, cfg=cfg)) == \
        bucketed


def test_farm_client_fetch_upload_local_disabled_and_dead(tmp_path):
    session = _FakeSession()
    client = FarmClient(session, signature="s1", aot_dir=str(tmp_path))
    assert client.upload({"aot-a.bin": b"aaa"}, compile_ms=5.0,
                         fingerprint="fp")
    path, body = session.posts[-1]
    assert path == "/api/v1/compile_cache/s1"
    assert set(body) == {"files", "compile_ms", "fingerprint"}
    assert client.fetch("aot-a.bin") == b"aaa"           # from the master
    assert client.fetch("aot-missing.bin") is None
    client.upload_async({"aot-b.bin": b"bbb"})
    client.wait()
    assert session.store["s1"]["aot-b.bin"] == b"bbb"
    # Local first: the prewarmed dir answers without a session.
    assert client.save_local({"aot-c.bin": b"ccc"})
    assert (tmp_path / "s1" / "aot-c.bin").read_bytes() == b"ccc"
    assert FarmClient(None, "s1", str(tmp_path)).fetch("aot-c.bin") == b"ccc"
    # No signature: every method is a no-op.
    off = FarmClient(session, signature="", aot_dir=str(tmp_path))
    assert not off.enabled
    assert off.fetch("aot-c.bin") is None
    assert not off.upload({"aot-d.bin": b"d"})
    assert not off.save_local({"aot-d.bin": b"d"})
    # A dead session never raises.
    dead = FarmClient(_DeadSession(), signature="s1", aot_dir="")
    assert dead.fetch("aot-a.bin") is None
    assert not dead.upload({"aot-a.bin": b"a"})
    dead.upload_async({"aot-a.bin": b"a"})
    dead.wait()


def _fake_nvcc(root, log, exit_code=0):
    """A CUDA_HOME whose bin/nvcc logs its arguments and copies a loadable
    shared object (the interpreter's _ctypes extension) to its -o."""
    bindir = root / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    body = f"exit {exit_code}" if exit_code else \
        f'cp "{_ctypes.__file__}" "$out"'
    nvcc.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> "{log}"\n'
        'while [ $# -gt 0 ]; do\n'
        '  if [ "$1" = "-o" ]; then out="$2"; fi\n'
        '  shift\n'
        'done\n'
        f"{body}\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return str(root)


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """_build with an empty kernel directory, a fake nvcc and no state from
    earlier loads; -> (the nvcc call log, a CUDA_HOME factory)."""
    monkeypatch.setenv("DET_KERNEL_DIR", str(tmp_path / "kernels"))
    for attr in ("_loaded", "build_seconds", "build_log", "sources"):
        monkeypatch.setattr(_build, attr, {})
    monkeypatch.setattr(_build, "_farm", None)
    log = tmp_path / "nvcc.log"

    def cuda_home(exit_code=0, name="cuda"):
        home = _fake_nvcc(tmp_path / name, log, exit_code)
        monkeypatch.setenv("CUDA_HOME", home)
        return home

    return log, cuda_home


def _calls(log):
    return log.read_text().splitlines() if log.exists() else []


def test_a_warm_hit_makes_no_nvcc_call(fresh_build, tmp_path):
    log, cuda_home = fresh_build
    cuda_home()
    good = open(_ctypes.__file__, "rb").read()
    aot = tmp_path / "aot"
    name = _build.artifact_name("paged_attention")
    (aot / "sig").mkdir(parents=True)
    (aot / "sig" / name).write_bytes(good)   # as the agent prewarms it
    farm = FarmClient(None, signature="sig", aot_dir=str(aot))
    assert isinstance(_build.load("paged_attention", farm=farm), ctypes.CDLL)
    assert _calls(log) == []
    assert _build.build_seconds == {"paged_attention": 0.0}
    assert _build.sources == {"paged_attention": "farm"}
    assert _build.library_path("paged_attention").read_bytes() == good
    assert _build.nvcc_built() == {}
    # A second process on the node finds it on disk.
    _build._loaded.clear()
    _build.sources.clear()
    _build.load("paged_attention")
    assert _build.sources == {"paged_attention": "disk"} and not _calls(log)


def test_a_bad_artifact_is_rebuilt_and_raises_without_nvcc(fresh_build,
                                                           tmp_path):
    log, cuda_home = fresh_build
    session = _FakeSession()
    name = _build.artifact_name("flash_attention")
    session.store["sig"] = {name: b"not a shared object"}
    farm = FarmClient(session, signature="sig", aot_dir="")
    # nvcc exits 1: the corrupt artifact cannot be replaced, and it raises
    # (nothing falls back to the plain versions).
    cuda_home(exit_code=1, name="broken")
    with pytest.raises(RuntimeError, match="failed to load .* cannot be "
                                           "rebuilt"):
        _build.load("flash_attention", farm=farm)
    assert len(_calls(log)) == 1
    assert "flash_attention" not in _build._loaded
    # A working nvcc: the load fails, is logged, and nvcc rebuilds it.
    _build.sources.clear()
    cuda_home()
    assert isinstance(_build.load("flash_attention", farm=farm), ctypes.CDLL)
    calls = _calls(log)
    assert len(calls) == 2 and "flash_attention.cu" in calls[-1]
    assert _build.sources["flash_attention"] == "nvcc"
    # ... and its good library replaces the bad one in the store.
    farm.wait()
    assert session.store["sig"][name] == open(_ctypes.__file__, "rb").read()


def test_a_fresh_build_is_uploaded(fresh_build, tmp_path):
    log, cuda_home = fresh_build
    cuda_home()
    session = _FakeSession()
    farm = FarmClient(session, signature="sig", aot_dir="")
    previous = _build.set_farm(farm)
    try:
        _build.load("paged_attention")       # resolves through set_farm
    finally:
        _build.set_farm(previous)
    farm.wait()
    assert len(_calls(log)) == 1
    assert set(_build.nvcc_built()) == {"paged_attention"}
    name = _build.artifact_name("paged_attention")
    assert name.startswith("aot-kernel_paged_attention-")
    assert session.store["sig"] == {
        name: _build.library_path("paged_attention").read_bytes()}
    path, body = session.posts[-1]
    assert path == "/api/v1/compile_cache/sig" and "compile_ms" in body
    # The fingerprint is the libraries' hashes and the runtime tag.
    fp, detail = tsig.step_fingerprint()
    assert detail == {"libraries": {n: _build.digest(n)
                                    for n in _build.SOURCES},
                      "runtime_tag": tsig.runtime_tag()}
    assert fp == tsig.step_fingerprint()[0]


class _RecordingMaster(_FakeSession):
    """The master's compile endpoints for a worker: the model def, the DONE
    jobs by fingerprint, links; every request recorded."""

    def __init__(self, model_def):
        super().__init__()
        self.model_def = model_def
        self.done = {}  # signature -> fingerprint
        self.requests = []

    def get(self, path, params=None, **kw):
        self.requests.append(("GET", path, sorted(params or {})))
        if path.endswith("/model_def"):
            return {"b64_tgz": self.model_def}
        if path == "/api/v1/compile_jobs":
            return {"jobs": [{"signature": s, "fingerprint": f}
                             for s, f in self.done.items()
                             if f == params.get("fingerprint")]}
        return super().get(path, params)

    def post(self, path, body=None, **kw):
        self.requests.append(("POST", path, sorted(body or {})))
        sig = path.split("/")[4]
        if path.startswith("/api/v1/compile_jobs/") and \
                (body or {}).get("state") == "DONE":
            self.done[sig] = body["fingerprint"]
        if path.endswith("/link"):
            self.store[sig] = dict(self.store[body["from"]])
        return super().post(path, body)


def _worker_requests(run_job, fixtures, hparams2):
    import determined_tpu.cli as cli

    master = _RecordingMaster(cli._tar_context(fixtures))
    hp = {"lr": 0.01, "global_batch_size": 4}
    first = run_job(master, "e" * 64, hp, 1, 1, {})
    second = run_job(master, "f" * 64, dict(hp, **hparams2), 1, 1, {})
    return master, first, second


def test_run_job_sends_the_jax_workers_requests(fresh_build, monkeypatch):
    from determined_tpu.compile.worker import run_job as jax_run_job
    from determined_tpu_torch.compile.worker import run_job

    log, cuda_home = fresh_build
    cuda_home()
    monkeypatch.setenv("FARM_D_MODEL", "64")
    monkeypatch.setenv("FARM_N_LAYER", "1")
    monkeypatch.delenv("DET_XLA_CACHE_DIR", raising=False)
    monkeypatch.delenv("DET_COMPILE_AOT_DIR", raising=False)
    jmaster, jfirst, jsecond = _worker_requests(jax_run_job, JAX_FIXTURES,
                                                {"lr": 0.5})
    tmaster, tfirst, tsecond = _worker_requests(run_job, TORCH_FIXTURES,
                                                {"lr": 0.5})
    assert tmaster.requests == jmaster.requests
    assert [p for m, p, _ in tmaster.requests] == [
        "/api/v1/experiments/1/model_def", "/api/v1/compile_jobs",
        "/api/v1/compile_cache/" + "e" * 64,
        "/api/v1/compile_jobs/" + "e" * 64,
        "/api/v1/experiments/1/model_def", "/api/v1/compile_jobs",
        "/api/v1/compile_jobs/" + "f" * 64 + "/link"]
    # Built once: one nvcc a library, each named for the agent's prewarm.
    assert len(_calls(log)) == len(_build.SOURCES)
    names = set(tmaster.store["e" * 64])
    assert names == {_build.artifact_name(n) for n in _build.SOURCES}
    assert all(n.startswith("aot-kernel_") for n in names)
    assert tsecond["linked_from"] == jsecond["linked_from"] == "e" * 64
    assert tmaster.store["f" * 64] == tmaster.store["e" * 64]
    assert set(tfirst) >= set(jfirst)
    assert tfirst["fingerprint"] == tsig.step_fingerprint()[0]


def test_run_job_refuses_an_unsafe_tar_and_main_posts_failed(tmp_path,
                                                             monkeypatch):
    import io
    import tarfile

    from determined_tpu_torch.compile import worker

    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        info = tarfile.TarInfo("../escape.py")
        info.size = 1
        tar.addfile(info, io.BytesIO(b"x"))
    master = _RecordingMaster(base64.b64encode(buf.getvalue()).decode())
    with pytest.raises(RuntimeError, match="unsafe path"):
        worker.run_job(master, "a" * 64, {}, 1, 1, {})
    monkeypatch.setattr(worker, "run_job", lambda *a: 1 / 0)
    monkeypatch.setenv("DET_MASTER", "http://127.0.0.1:1")
    monkeypatch.setenv("DET_COMPILE_SIGNATURE", "a" * 64)
    posted = []

    class Session:
        def __init__(self, *a):
            pass

        def post(self, path, body=None, **kw):
            posted.append((path, body))

    import determined_tpu_torch.common.api as api

    monkeypatch.setattr(api, "Session", Session)
    assert worker.main() == 1
    assert posted == [("/api/v1/compile_jobs/" + "a" * 64, {
        "state": "FAILED", "error": "ZeroDivisionError: division by zero"})]


def _keys_fit(tmp_path, name, core, trainer, ctx_cls, trial_cls, farm,
              **kw):
    """A 2-step fit with `farm` -> (its first flush, its harness.compile
    spans)."""
    ctx = core.init(max_length=2, checkpoint_dir=str(tmp_path / name))
    # No upload: the JAX farm would export the step by compiling it again.
    tr = trainer(trial_cls(ctx_cls(core_context=ctx), tb.numpy_params(),
                           {"upload": False}), core_context=ctx, **kw)
    tr._farm = farm
    tr.fit(report_period=1)
    ctx.tracer.flush()
    ctx.close()
    return (ctx.train.local_training_metrics[0]["metrics"],
            [s for s in ctx.tracer.local_spans
             if s["name"] == "harness.compile"])


def test_trainer_first_flush_and_span_have_the_jax_keys(tmp_path,
                                                        monkeypatch):
    import jax

    from determined_tpu import core as jcore
    from determined_tpu.train import Trainer as JTrainer
    from determined_tpu.train.trial import TrialContext as JTrialContext
    from determined_tpu_torch import core as tcore
    from determined_tpu_torch.train import Trainer as TTrainer
    from determined_tpu_torch.train.trial import TrialContext as TTrialContext

    monkeypatch.delenv("DET_COMPILE_AOT_DIR", raising=False)
    # The JAX fit (mostly XLA compiles) runs on a thread beside the port's.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(
            _keys_fit, tmp_path, "jax", jcore, JTrainer, JTrialContext,
            tb.JaxGPT2, JFarmClient(_FakeSession(), "sig", aot_dir="",
                                    xla_cache_dir=""),
            devices=jax.devices()[:1])
        tflush, tspans = _keys_fit(
            tmp_path, "torch", tcore, TTrainer, TTrialContext, tb.TorchGPT2,
            FarmClient(_FakeSession(), "sig", aot_dir=""), device="cpu")
        jflush, jspans = jax_run.result()
    assert set(tflush) == set(jflush)
    assert {"compile_ms", "compile_cache_hit", "attention_impl"} <= set(tflush)
    assert tflush["compile_cache_hit"] == 0.0     # nothing built on the CPU
    assert [s["attrs"]["executable"] for s in tspans] == \
        [s["attrs"]["executable"] for s in jspans] == \
        ["train_step", "eval_step"]
    for t, j in zip(tspans, jspans):
        assert set(t["attrs"]) == set(j["attrs"])
        assert t["attrs"]["signature"] == "sig"
        assert t["attrs"]["cache_hit"] is False
    np.testing.assert_allclose(tflush["loss"], jflush["loss"], atol=1e-4)
