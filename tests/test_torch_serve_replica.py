"""The port's serve replica as its entry point builds it: the base and an
adapter restored from the trainer's checkpoints (through the lineage,
shared_fs only), the sampler prepared as the JAX engine prepares it, and
`main` attached to a fake master, reporting and draining.

These are test_torch_serve_task.py's replica checks; its helpers are
imported from there."""

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
from determined_tpu.serve.task import _trial_id_for as jax_trial_id_for
from determined_tpu_torch.common import faultpoint
from determined_tpu_torch.core import _integrity
from determined_tpu_torch.core._checkpoint import CheckpointContext
from determined_tpu_torch.serve import ContinuousBatcher, ServingEngine
from determined_tpu_torch.serve.engine import load_checkpoint_params
from determined_tpu_torch.serve import model as smodel
from determined_tpu_torch.serve.task import _trial_id_for, build_replica, checkpoint_base
from test_torch_serve_task import (  # noqa: F401 (fixtures)
    REPO,
    TINY,
    TCFG,
    PROMPT,
    _clean_faults,
    params,
    finetune,
    _batcher,
    _save,
    _truncate,
    _wte,
    _serve_config,
    _generate,
)


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
