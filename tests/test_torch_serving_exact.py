"""The port's serving stack end to end, against the JAX package: greedy
generations through the engine, prefix-cache hits and a burst through the
batcher, the HTTP front-end and the replica's entry point.

These are test_torch_serving.py's checks that generate tokens and hold
them to the JAX engine or to full-forward JAX greedy decoding; its
helpers and fixtures are imported from there."""

import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from determined_tpu.serve.engine import ServingEngine as JaxEngine
from determined_tpu_torch.models import gpt2 as tgpt2
from determined_tpu_torch.serve import Request
from determined_tpu_torch.serve.http import ServingServer, prometheus_exposition
from test_torch_serving import (  # noqa: F401 (fixtures)
    JCFG,
    _clean_faults,
    params,
    reference_greedy,
    make_engine,
    make_batcher,
    greedy_via_engine,
)


def test_engine_greedy_matches_jax_engine(params):
    prompt = [5, 9, 17, 3, 77, 41]
    jeng = JaxEngine(jax.tree_util.tree_map(jnp.asarray, params), JCFG,
                     slots=2, max_seq_len=32, prefill_buckets=[8, 16],
                     attention_impl="reference")
    jeng.compile()
    teng = make_engine(params, slots=2, buckets=(8, 16))
    teng.compile()
    jax_tokens = greedy_via_engine(jeng, prompt, 8)
    assert greedy_via_engine(teng, prompt, 8) == jax_tokens
    assert jax_tokens == reference_greedy(params, prompt, 8)
    assert len(set(jax_tokens)) > 1  # a non-degenerate sequence
    assert teng.decode_steps == 7 and teng.attention_launches == 0


def test_burst_completes_with_occupancy_above_one(params):
    eng = make_engine(params, slots=4)
    b = make_batcher(eng).start()
    try:
        rng = np.random.default_rng(0)
        reqs = [b.submit(Request(
            rng.integers(1, 100, size=int(rng.integers(2, 7))),
            max_new_tokens=int(rng.integers(3, 10)))) for _ in range(16)]
        results = [r.result(timeout=120) for r in reqs]
        stats = b.stats()
        assert stats["completed"] == 16 and stats["failed"] == 0
        assert stats["mean_occupancy"] > 1.0 and stats["max_occupancy"] > 1
        for req, res in [(reqs[0], results[0]), (reqs[-1], results[-1])]:
            assert res["tokens"] == reference_greedy(
                params, req.tokens, req.max_new_tokens)
        kv = stats["kv_blocks"]
        assert kv["used_blocks"] == 0
        assert kv["total_freed"] == kv["total_allocated"] > 0
    finally:
        b.stop()


def test_shared_prefix_admits_at_suffix_cost_and_stays_exact(params):
    eng = make_engine(params, slots=4)
    b = make_batcher(eng, block_size=8).start()
    try:
        shared = list(np.arange(1, 25))          # 3 full blocks
        p1 = np.asarray(shared + [30, 31], np.int32)
        p2 = np.asarray(shared + [40, 41], np.int32)
        r1 = b.submit(Request(p1, max_new_tokens=4))
        r1.result(timeout=60)
        alloc = b.blocks.total_allocated
        r2 = b.submit(Request(p2, max_new_tokens=4))
        r2.result(timeout=60)
        assert b.blocks.total_allocated - alloc == 1
        kv = b.blocks.stats()
        assert kv["prefix_hit_tokens"] == 24 and kv["prefix_hits"] == 1
        assert r1.out_tokens == reference_greedy(params, p1, 4)
        assert r2.out_tokens == reference_greedy(params, p2, 4)
    finally:
        b.stop()


def test_identical_prompt_full_hit_copies_block_and_stays_exact(params):
    eng = make_engine(params, slots=2)
    b = make_batcher(eng, block_size=8)
    try:
        prompt = np.asarray(np.arange(1, 17), np.int32)  # 2 full blocks
        r1 = b.submit(Request(prompt, max_new_tokens=5))
        r2 = b.submit(Request(prompt, max_new_tokens=5))
        b.start()
        r1.result(timeout=60)
        r2.result(timeout=60)
        ref = reference_greedy(params, prompt, 5)
        assert r1.out_tokens == ref and r2.out_tokens == ref
        assert b.blocks.stats()["cow_copies"] == 1 and eng.block_copies == 1
    finally:
        b.stop()


def _http(method, url, body=None, timeout=30.0):
    req = urllib.request.Request(
        url, method=method,
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture()
def http_replica(params):
    eng = make_engine(params, slots=2)
    b = make_batcher(eng).start()
    server = ServingServer(b, host="127.0.0.1", port=0).start()
    yield f"http://127.0.0.1:{server.port}", b
    server.stop()
    b.stop()


def test_http_generate_stats_metrics_health(http_replica, params):
    url, _ = http_replica
    status, body = _http("POST", url + "/v1/generate",
                         {"tokens": [5, 9, 17, 3], "max_new_tokens": 6})
    assert status == 200
    assert json.loads(body)["tokens"] == reference_greedy(
        params, [5, 9, 17, 3], 6)
    status, body = _http("GET", url + "/v1/stats")
    stats = json.loads(body)
    assert status == 200 and stats["completed"] >= 1
    assert stats["engine"]["decode_steps"] == 5
    assert stats["engine"]["attention_impl"] == "reference"
    status, body = _http("GET", url + "/metrics")
    assert status == 200 and b"det_serve_prefix_cache_hit_rate" in body
    status, body = _http("GET", url + "/healthz")
    assert (status, json.loads(body)["status"]) == (200, "ok")
    assert "det_serve_kv_blocks_used" in prometheus_exposition(stats)


def test_http_error_codes(http_replica):
    url, batcher = http_replica
    assert _http("POST", url + "/v1/generate", {"tokens": []})[0] == 400
    assert _http("POST", url + "/v1/generate",
                 {"tokens": list(range(1, 40))})[0] == 400  # no bucket
    assert _http("POST", url + "/v1/generate",
                 {"tokens": [1, 2], "model": "nope"})[0] == 400
    batcher.queue.drain()
    assert _http("POST", url + "/v1/generate",
                 {"tokens": [1, 2], "max_new_tokens": 2})[0] == 503
    status, body = _http("GET", url + "/healthz")
    assert json.loads(body)["status"] == "draining"
    batcher.queue.undrain()
    assert _http("POST", url + "/v1/generate",
                 {"tokens": [1, 2], "max_new_tokens": 2})[0] == 200


def test_http_429_when_the_queue_is_full(params):
    eng = make_engine(params, slots=2)
    b = make_batcher(eng, queue_size=1)
    eng.compile()  # no start(): the parked queue fills deterministically
    server = ServingServer(b, host="127.0.0.1", port=0).start()
    try:
        url = f"http://127.0.0.1:{server.port}/v1/generate"
        body = {"tokens": [1, 2], "max_new_tokens": 2, "timeout_s": 0.1}
        assert _http("POST", url, body)[0] == 504  # accepted, never served
        req = urllib.request.Request(
            url, method="POST", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=10)
        assert err.value.code == 429
        assert int(err.value.headers["Retry-After"]) >= 1
    finally:
        server.stop()
        b.stop()


def test_main_serves_and_drains_on_sigterm(params, tmp_path):
    """`python -m determined_tpu_torch.serve cfg.json` on the CPU (asked
    for by name): serve one request, then SIGTERM drains and exits 0."""
    import os
    import re
    import signal
    import subprocess
    import sys

    path = str(tmp_path / "params.npz")
    tgpt2.save_params_npz(path, tgpt2.params_from_numpy(params))
    cfg_path = tmp_path / "serve.json"
    cfg_path.write_text(json.dumps({"serving": {
        "checkpoint": path, "device": "cpu", "max_batch_size": 2,
        "max_seq_len": 32, "kv_block_size": 8, "prefill_buckets": [8, 16],
        "model_config": {"vocab_size": 128, "n_positions": 64,
                         "d_model": 32, "n_layer": 2, "n_head": 2,
                         "dtype": "float32"}}}))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.Popen(
        [sys.executable, "-m", "determined_tpu_torch.serve", str(cfg_path)],
        cwd=repo, env=env, stderr=subprocess.PIPE, text=True)
    try:
        port = None
        for line in proc.stderr:
            m = re.search(r"serve replica up on port (\d+)", line)
            if m:
                port = int(m.group(1))
                break
        assert port, "replica never came up"
        status, body = _http("POST", f"http://127.0.0.1:{port}/v1/generate",
                             {"tokens": [5, 9, 17, 3], "max_new_tokens": 4})
        assert status == 200
        assert json.loads(body)["tokens"] == reference_greedy(
            params, [5, 9, 17, 3], 4)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stderr.close()
