"""A managed trial of the port's Trainer against the JAX Trainer's, on the CPU.

Both packages train the same tiny fp32 GPT-2 (numpy-drawn params, fixed
numpy batches, their device prefetchers on, async checkpoints on) as a
cluster trial against a fake master of their own (a stdlib
`ThreadingHTTPServer`, one copy in this file): one searcher op of
`LENGTH` steps, a report every step. Run A: the master answers the
preemption long-poll (deadline 60 s) once it has seen the training report
of step `PREEMPT_AT`; `fit` must ack, save and commit `trial7-step3` (the
registry sees PARTIAL, then COMPLETED) and return at that step. Run B: a
fresh process context with `DET_LATEST_CHECKPOINT` set to the registered
id restores it (bitwise A's final state, in the port), trains to `LENGTH`,
commits `trial7-step6`, completes the op and stops at the searcher's
`done`. Both packages' tfevents writer is replaced by `ScalarRecorder`
(`torch.utils.tensorboard` would pull in TensorFlow on a CPU host), which
must see the same training scalars from both.

Tolerance: the losses and grad norms of all six steps, and the searcher
metric, atol 1e-4 / rtol 1e-5 against the JAX Trainer's (fp32, the same
arithmetic in another summation order, through the optimizer's updates:
the tolerance of tests/test_torch_trainer.py).
"""

import json
import os
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from determined_tpu import _info as jinfo
from determined_tpu import core as jcore
from determined_tpu import tensorboard as jtensorboard
from determined_tpu.models import gpt2 as jgpt2
from determined_tpu.train import JaxTrial
from determined_tpu.train import Trainer as JTrainer
from determined_tpu.train.trial import TrialContext as JTrialContext
from determined_tpu_torch import core as tcore
from determined_tpu_torch import tensorboard as ttensorboard
from determined_tpu_torch.core._checkpoint import _map_tensors
from determined_tpu_torch.models import gpt2 as tgpt2
from determined_tpu_torch.train import TorchTrial
from determined_tpu_torch.train import Trainer as TTrainer
from determined_tpu_torch.train import optim
from determined_tpu_torch.train.trial import TrialContext as TTrialContext

DIMS = dict(vocab_size=64, n_positions=32, d_model=32, n_layer=2, n_head=2)
TRIAL = 7
LENGTH = 6
PREEMPT_AT = 3


class ScalarRecorder:
    """Stands in for both packages' tfevents `MetricWriter`; keeps the
    scalars of every writer made in `made`."""

    made = []

    def __init__(self, log_dir):
        self.scalars = []
        self.made.append(self)

    def add_scalars(self, metrics, step, prefix=""):
        self.scalars += [(f"{prefix}{k}", step) for k in metrics]

    def flush(self):
        pass

    def close(self):
        pass


@pytest.fixture(autouse=True)
def _scalar_recorder(monkeypatch):
    monkeypatch.setattr(jtensorboard, "MetricWriter", ScalarRecorder)
    monkeypatch.setattr(ttensorboard, "MetricWriter", ScalarRecorder)
    ScalarRecorder.made.clear()


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


def numpy_params(seed=0, std=0.2):
    rng = np.random.default_rng(seed)
    cfg = tgpt2.Config(**DIMS, dtype=torch.float32)
    flat = tgpt2._flatten(tgpt2.init(torch.Generator().manual_seed(0), cfg))
    return tgpt2._unflatten({
        k: ((1.0 if k.endswith("scale") else 0.0)
            + std * rng.normal(size=tuple(v.shape))).astype(np.float32)
        for k, v in flat.items()})


def batches(seed, n, b=4, s=17):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, DIMS["vocab_size"], size=(b, s))
             .astype(np.int32)} for _ in range(n)]


class JaxGPT2(JaxTrial):
    def __init__(self, context, params):
        super().__init__(context)
        self.cfg = jgpt2.Config(**DIMS, dtype=jnp.float32)
        self.params = params

    def init_params(self, rng):
        return jax.tree_util.tree_map(jnp.asarray, self.params)

    def loss(self, params, batch, rng):
        return jgpt2.loss_fn(params, batch, self.cfg)

    def optimizer(self):
        return optax.adamw(1e-3, b2=0.95, weight_decay=0.1)

    def build_training_data(self):
        return batches(1, 16)

    def build_validation_data(self):
        return batches(2, 2)

    def evaluate(self, params, batch):
        return {"validation_loss": jgpt2.loss_fn(params, batch, self.cfg)}


class TorchGPT2(TorchTrial):
    def __init__(self, context, params):
        super().__init__(context)
        self.cfg = tgpt2.Config(**DIMS, dtype=torch.float32)
        self.params = params

    def init_params(self, rng):
        return tgpt2.params_from_numpy(self.params, rng.device)

    def loss(self, params, batch, rng):
        return tgpt2.loss_fn(params, batch, self.cfg)

    def optimizer(self):
        return optim.adamw(1e-3, b2=0.95, weight_decay=0.1)

    def build_training_data(self):
        return batches(1, 16)

    def build_validation_data(self):
        return batches(2, 2)

    def evaluate(self, params, batch):
        return {"validation_loss": tgpt2.loss_fn(params, batch, self.cfg)}


class FakeMaster:
    """The endpoints a managed trial speaks, recorded. The preemption
    long-poll is answered once the training report of `preempt_at` has
    arrived; that report's answer waits until the signal is out, so the
    trial sees it at that step's poll."""

    def __init__(self, preempt_at=None):
        self.requests = []
        self.registry = []  # COMPLETED checkpoint ids, newest first
        self.preempt_at = preempt_at
        self._armed = threading.Event()
        self._sent = threading.Event()
        self._released = threading.Event()
        master = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _answer(self):
                url = urllib.parse.urlsplit(self.path)
                query = dict(urllib.parse.parse_qsl(url.query))
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n)) if n else None
                out = master.answer(self.command, url.path, query, body)
                data = json.dumps(out).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                if url.path.endswith("/signals/preemption") and \
                        out.get("preempt"):
                    master._sent.set()

            do_GET = do_POST = _answer

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self._server.server_address[1]}"
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()

    def answer(self, method, path, query, body):
        if path.endswith("/signals/preemption"):
            while not (self._armed.is_set() or self._released.is_set()):
                self._armed.wait(0.05)
            if self._armed.is_set():
                return {"preempt": True, "deadline_seconds": 60,
                        "reason": "spot"}
            time.sleep(0.01)  # released: the watcher is being closed
            return {}
        self.requests.append((method, path, query, body))
        if path.endswith("/searcher/operation"):
            done = int(query["last"]) >= LENGTH
            return {"done": True} if done else {"op": {"length": LENGTH}}
        if path == "/api/v1/checkpoints" and body["state"] == "COMPLETED":
            self.registry.insert(0, body["uuid"])
        if path.endswith("/checkpoints"):
            return {"checkpoints": [{"uuid": u} for u in self.registry]}
        if path.endswith("/metrics") and body["group"] == "training" and \
                body["steps_completed"] == self.preempt_at and \
                not self._armed.is_set():
            self._armed.set()
            assert self._sent.wait(10)
            time.sleep(0.2)  # the watcher takes the signal in
        return {}

    def close(self):
        self._released.set()
        self._server.shutdown()
        self._server.server_close()

    def posted(self, suffix):
        return [b for m, p, q, b in self.requests
                if m == "POST" and p.endswith(suffix)]


def _env(monkeypatch, master, storage, latest=None):
    for k in [k for k in os.environ if k.startswith("DET_")]:
        monkeypatch.delenv(k)
    env = {"DET_MASTER": master.url, "DET_TRIAL_ID": str(TRIAL),
           "DET_EXPERIMENT_ID": "1", "DET_ALLOCATION_ID": "alloc-7",
           "DET_SESSION_TOKEN": "tok",
           "DET_EXPERIMENT_CONFIG": json.dumps({"checkpoint_storage": {
               "type": "shared_fs", "host_path": str(storage)}})}
    if latest:
        env["DET_LATEST_CHECKPOINT"] = latest
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jinfo.get_cluster_info(refresh=True)  # the JAX package caches it


def _run(monkeypatch, storage, latest, make_trial, core_mod, make_trainer):
    """One process of the managed trial: -> (master, final state, ctx)."""
    master = FakeMaster(preempt_at=None if latest else PREEMPT_AT)
    _env(monkeypatch, master, storage, latest)
    try:
        ctx = core_mod.init()
        state = make_trainer(make_trial(ctx), ctx).fit(report_period=1,
                                                       preempt_period=1)
        master._released.set()
        ctx.close()
    finally:
        master.close()
    return master, state, ctx


def tensors(state):
    """Every tensor of a TrainState (params and optimizer state), in
    order."""
    out = []
    _map_tensors(state, out.append)
    return out


@pytest.fixture(scope="module")
def params():
    return numpy_params()


def _trajectory(masters):
    out = {}
    for m in masters:
        for b in m.posted("/metrics"):
            if b["group"] == "training" and "loss" in b["metrics"]:
                out[b["steps_completed"]] = (b["metrics"]["loss"],
                                             b["metrics"]["grad_norm"])
    return [out[s] for s in sorted(out)], sorted(out)


def test_preempt_and_resume_matches_the_jax_trainer(tmp_path, monkeypatch,
                                                     params):
    sid = f"trial{TRIAL}-step{PREEMPT_AT}"
    runs, losses = {}, {}
    for name, core_mod, make_trial, make_trainer in (
            ("torch", tcore,
             lambda ctx: TorchGPT2(TTrialContext(core_context=ctx), params),
             lambda trial, ctx: TTrainer(trial, core_context=ctx,
                                         device="cpu")),
            ("jax", jcore,
             lambda ctx: JaxGPT2(JTrialContext(core_context=ctx), params),
             lambda trial, ctx: JTrainer(trial, core_context=ctx,
                                         devices=jax.devices()[:1]))):
        storage = tmp_path / name
        a, a_state, a_ctx = _run(monkeypatch, storage, None, make_trial,
                                 core_mod, make_trainer)
        assert a.registry == [sid]
        b, b_state, b_ctx = _run(monkeypatch, storage, sid, make_trial,
                                 core_mod, make_trainer)
        runs[name] = (a, b, a_state, b_state, a_ctx)
        losses[name] = [s for w in ScalarRecorder.made for s in w.scalars
                        if s[0] == "training/loss"]
        ScalarRecorder.made.clear()

    a, b, a_state, b_state, a_ctx = runs["torch"]
    # Run A: acked, saved, committed and stopped at the preemption.
    assert a_state.step == PREEMPT_AT
    assert a.posted("/signals/ack_preemption")
    assert [(c["uuid"], c["state"]) for c in a.posted("/api/v1/checkpoints")
            ] == [(sid, "PARTIAL"), (sid, "COMPLETED")]
    assert a.posted("/searcher/completed_operation") == []
    restored = a_ctx.checkpoint.restore_state(sid, a_state)
    got, want = tensors(restored), tensors(a_state)
    assert len(got) == len(want) > len(a_state.leaves())  # and the moments
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    # Run B: resumed there, finished the op, stopped at `done`.
    assert b_state.step == LENGTH
    end = f"trial{TRIAL}-step{LENGTH}"
    assert [(c["uuid"], c["state"]) for c in b.posted("/api/v1/checkpoints")
            ] == [(end, "PARTIAL"), (end, "COMPLETED")]
    ops = [q for m, p, q, _ in b.requests if p.endswith("/operation")]
    assert [q["last"] for q in ops] == ["0", str(LENGTH)]
    spans = [s["name"] for s in (sp for body in a.posted("/spans")
                                 for sp in body["spans"])]
    assert "harness.checkpoint.emergency" in spans

    # Against the JAX Trainer: the same reports, the same numbers.
    ja, jb = runs["jax"][:2]
    ours, steps = _trajectory([a, b])
    theirs, jsteps = _trajectory([ja, jb])
    assert steps == jsteps == list(range(1, LENGTH + 1))
    np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=1e-5)
    for m, jm in ((a, ja), (b, jb)):
        assert [(c["uuid"], c["state"]) for c in
                m.posted("/api/v1/checkpoints")] == \
            [(c["uuid"], c["state"]) for c in jm.posted("/api/v1/checkpoints")]
        assert [p for _, p, _, _ in m.requests
                if not p.endswith(("/metrics", "/spans"))] == \
            [p for _, p, _, _ in jm.requests
             if not p.startswith("/api/v1/compile")
             and not p.endswith(("/metrics", "/spans"))]
    assert losses["torch"] == losses["jax"] == [
        ("training/loss", s) for s in range(1, LENGTH + 1)]
    (metric,) = b.posted("/searcher/completed_operation")
    (jmetric,) = jb.posted("/searcher/completed_operation")
    assert metric["length"] == jmetric["length"] == LENGTH
    np.testing.assert_allclose(metric["searcher_metric"],
                               jmetric["searcher_metric"],
                               atol=1e-4, rtol=1e-5)
