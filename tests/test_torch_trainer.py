"""The port's local-mode Trainer against the JAX package's, on the CPU.

A tiny fp32 GPT-2 trial with numpy-drawn params and fixed numpy batches
runs through `determined_tpu.train.Trainer` (one CPU device, both with
their device prefetcher) and through `determined_tpu_torch.train.Trainer`
(`device="cpu"`): the loss reported at every step, the validation loss and
the metric keys must agree. Then the port alone: a checkpoint restored by
`resume_from` in a fresh Trainer continues at its step with identical
params; `health.on_nan: rollback` rewinds to the last COMMITTED
checkpoint, with the prefetcher off and on; a faked preemption takes the preemption checkpoint; the
`step.hang` fault point fires the step watchdog; and what `core.init()`
makes of each cluster variable alone.

Tolerance: losses atol 1e-4 over 4 steps (fp32, the same arithmetic in
another summation order, through the optimizer's updates).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from determined_tpu.models import gpt2 as jgpt2
from determined_tpu.train import JaxTrial
from determined_tpu_torch import core as tcore
from determined_tpu_torch.models import gpt2 as tgpt2
from determined_tpu_torch.train import TorchTrial
from determined_tpu_torch.train import Trainer as TTrainer
from determined_tpu_torch.train import optim
from determined_tpu_torch.train.health import DivergenceError
from determined_tpu_torch.train.trial import TrialContext as TTrialContext

DIMS = dict(vocab_size=64, n_positions=32, d_model=32, n_layer=2, n_head=2)


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
        sched = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 1, 100)
        return optax.chain(optax.clip_by_global_norm(1.0),
                           optax.adamw(sched, b2=0.95, weight_decay=0.1))

    def build_training_data(self):
        return batches(1, 16)

    def build_validation_data(self):
        return batches(2, 2)

    def evaluate(self, params, batch):
        return {"validation_loss": jgpt2.loss_fn(params, batch, self.cfg)}


class TorchGPT2(TorchTrial):
    def __init__(self, context, params, poison_step=None):
        super().__init__(context)
        self.cfg = tgpt2.Config(**DIMS, dtype=torch.float32)
        self.params = params
        self.poison_step = poison_step
        self.batches_drawn = 0
        self.batches_stepped = []  # the draw number of each step's batch

    def init_params(self, rng):
        return tgpt2.params_from_numpy(self.params, rng.device)

    def loss(self, params, batch, rng):
        loss = tgpt2.loss_fn(params, batch, self.cfg)
        if "drawn" in batch:
            self.batches_stepped.append(int(batch["drawn"]))
        if "poison" in batch and bool(batch["poison"]):
            loss = loss * float("nan")
        return loss

    def optimizer(self):
        sched = optim.warmup_cosine_decay_schedule(0.0, 1e-3, 1, 100)
        return optim.chain(optim.clip_by_global_norm(1.0),
                           optim.adamw(sched, b2=0.95, weight_decay=0.1))

    def build_training_data(self):
        for batch in batches(1, 16):
            self.batches_drawn += 1
            if self.batches_drawn == self.poison_step:
                batch = dict(batch, poison=np.array(True),
                             drawn=np.array(self.batches_drawn))
            elif self.poison_step is not None:
                batch = dict(batch, drawn=np.array(self.batches_drawn))
            yield batch

    def build_validation_data(self):
        return batches(2, 2)

    def evaluate(self, params, batch):
        return {"validation_loss": tgpt2.loss_fn(params, batch, self.cfg)}


def _port_fit(tmp_path, max_length, **fit_kwargs):
    ctx = tcore.init(max_length=max_length,
                     checkpoint_dir=str(tmp_path / "ckpt"))
    trial = TorchGPT2(TTrialContext(core_context=ctx), numpy_params())
    trainer = TTrainer(trial, core_context=ctx, device="cpu")
    state = trainer.fit(**fit_kwargs)
    return ctx, trainer, state


def test_on_nan_fail_raises(tmp_path):
    ctx = tcore.init(max_length=4, checkpoint_dir=str(tmp_path / "ckpt"))
    trial = TorchGPT2(TTrialContext(core_context=ctx), numpy_params(),
                      poison_step=2)
    trial.health = {"on_nan": "fail"}
    with pytest.raises(DivergenceError, match="step 2"):
        TTrainer(trial, core_context=ctx, device="cpu").fit(report_period=1)
    ctx.close()


def test_preemption_takes_the_preemption_checkpoint(tmp_path):
    ctx = tcore.init(max_length=6, checkpoint_dir=str(tmp_path / "ckpt"))
    ctx.preempt.should_preempt = lambda auto_ack=True: True
    trial = TorchGPT2(TTrialContext(core_context=ctx), numpy_params())
    state = TTrainer(trial, core_context=ctx, device="cpu").fit(
        report_period=1, preempt_period=2)
    ctx.close()
    assert state.step == 2
    assert ctx.checkpoint.lineage() == ["trial0-step2"]
    assert ctx.searcher.completed_metrics == []  # the op did not complete


class _RecordingMaster:
    """A stdlib master that answers every request {} and records it."""

    def __init__(self):
        import json
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        got = self.requests = []

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _answer(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n) if n else b""
                got.append((self.command, self.path.split("?")[0],
                            json.loads(body) if body else None))
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

            do_GET = do_POST = _answer

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self._server.server_address[1]}"
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()

    def close(self):
        self._server.shutdown()
        self._server.server_close()


@pytest.mark.parametrize("var", ["DET_MASTER", "DET_TRIAL_ID",
                                 "DET_ALLOCATION_ID"])
def test_core_init_in_a_cluster_environment(monkeypatch, tmp_path, var):
    """What core.init() makes of each variable an agent sets, alone: with
    DET_MASTER a managed context that reports `run_prepare` to that
    master; DET_TRIAL_ID or DET_ALLOCATION_ID without a master is local
    mode, as in the JAX package."""
    import os

    from determined_tpu import _info as jinfo

    for k in [k for k in os.environ if k.startswith("DET_")]:
        monkeypatch.delenv(k)
    master = _RecordingMaster()
    monkeypatch.setenv(var, master.url if var == "DET_MASTER" else "7")
    try:
        ctx = tcore.init(max_length=1, checkpoint_dir=str(tmp_path))
        jinfo_now = jinfo.get_cluster_info(refresh=True)
        ctx.close()
    finally:
        master.close()
        # The JAX package caches its ClusterInfo: read it again from the
        # environment as it will be after this test.
        for k in [k for k in os.environ if k.startswith("DET_")]:
            monkeypatch.delenv(k)
        jinfo.get_cluster_info(refresh=True)
    managed = var == "DET_MASTER"
    assert (ctx.info is not None) == managed == (jinfo_now is not None)
    if managed:
        assert ctx.info.master_url == jinfo_now.master_url == master.url
        assert ("POST", "/api/v1/trials/0/run_prepare", {}) in \
            master.requests
        assert ctx.checkpoint._session is not None
    else:
        assert master.requests == []
        assert ctx.checkpoint._session is None
        assert list(ctx.searcher.operations())[0].length == 1


def test_trainer_refuses_a_mesh_of_more_than_one_device(tmp_path):
    ctx = tcore.init(max_length=1, checkpoint_dir=str(tmp_path / "ckpt"))
    for mesh in ({"data": 2}, {"pipeline": 2}, {"expert": 4}):
        trial = TorchGPT2(TTrialContext(hparams={"mesh": mesh},
                                        core_context=ctx), numpy_params())
        with pytest.raises(ValueError, match="one device"):
            TTrainer(trial, core_context=ctx, device="cpu")


def test_step_hang_fault_point_fires_the_watchdog(tmp_path, monkeypatch):
    """The `step.hang` fault point in the loop, armed as a delay longer
    than health.step_timeout_sec, makes the step watchdog fire (here with
    a recording exit function instead of os._exit)."""
    import io

    from determined_tpu_torch.common import faultpoint
    from determined_tpu_torch.train import trainer as trainer_mod

    fired = []

    class Recording(trainer_mod.StepWatchdog):
        def __init__(self, timeout_sec, **kw):
            super().__init__(timeout_sec, exit_fn=fired.append,
                             stream=io.StringIO(), **kw)

    monkeypatch.setattr(trainer_mod, "StepWatchdog", Recording)
    ctx = tcore.init(max_length=2, checkpoint_dir=str(tmp_path / "ckpt"))
    trial = TorchGPT2(TTrialContext(core_context=ctx), numpy_params())
    trial.health = {"step_timeout_sec": 0.2}
    faultpoint.arm("step.hang", "delay-800", count=1)
    try:
        state = TTrainer(trial, core_context=ctx, device="cpu").fit(
            report_period=1)
    finally:
        faultpoint.disarm("step.hang")
    ctx.close()
    assert fired == [87]
    assert state.step == 2
