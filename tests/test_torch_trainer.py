"""The port's local-mode Trainer against the JAX package's, on the CPU.

A tiny fp32 GPT-2 trial with numpy-drawn params and fixed numpy batches
runs through `determined_tpu.train.Trainer` (one CPU device, no
prefetcher) and through `determined_tpu_torch.train.Trainer`
(`device="cpu"`): the loss reported at every step, the validation loss and
the metric keys must agree. Then the port alone: a checkpoint restored by
`resume_from` in a fresh Trainer continues at its step with identical
params; `health.on_nan: rollback` rewinds to the last COMMITTED
checkpoint; a faked preemption takes the preemption checkpoint; the
`step.hang` fault point fires the step watchdog; and `core.init()`
refuses a cluster environment.

Tolerance: losses atol 1e-4 over 4 steps (fp32, the same arithmetic in
another summation order, through the optimizer's updates).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from determined_tpu import core as jcore
from determined_tpu.models import gpt2 as jgpt2
from determined_tpu.train import JaxTrial
from determined_tpu.train import Trainer as JTrainer
from determined_tpu.train.trial import TrialContext as JTrialContext
from determined_tpu_torch import core as tcore
from determined_tpu_torch.models import gpt2 as tgpt2
from determined_tpu_torch.train import TorchTrial
from determined_tpu_torch.train import Trainer as TTrainer
from determined_tpu_torch.train import optim
from determined_tpu_torch.train.health import DivergenceError
from determined_tpu_torch.train.trial import TrialContext as TTrialContext

DIMS = dict(vocab_size=64, n_positions=32, d_model=32, n_layer=2, n_head=2)
# Keys only the JAX Trainer reports: its compile-farm events.
COMPILE_FARM_KEYS = {"compile_ms", "compile_cache_hit", "attention_impl"}


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
    prefetch = False

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

    def init_params(self, rng):
        return tgpt2.params_from_numpy(self.params, rng.device)

    def loss(self, params, batch, rng):
        loss = tgpt2.loss_fn(params, batch, self.cfg)
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
                batch = dict(batch, poison=np.array(True))
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


def test_fit_reports_the_jax_trainers_losses(tmp_path):
    params = numpy_params()
    jctx = jcore.init(max_length=4, checkpoint_dir=str(tmp_path / "jax"))
    JTrainer(JaxGPT2(JTrialContext(core_context=jctx), params),
             core_context=jctx, devices=jax.devices()[:1]).fit(
        report_period=1)
    jctx.close()
    tctx, _, state = _port_fit(tmp_path, 4, report_period=1)
    tctx.close()

    jrep = jctx.train.local_training_metrics
    trep = tctx.train.local_training_metrics
    assert [r["steps_completed"] for r in trep] == \
        [r["steps_completed"] for r in jrep] == [1, 2, 3, 4]
    for j, t in zip(jrep, trep):
        assert set(t["metrics"]) == set(j["metrics"]) - COMPILE_FARM_KEYS
        for k in ("loss", "grad_norm", "all_finite"):
            np.testing.assert_allclose(t["metrics"][k], j["metrics"][k],
                                       atol=1e-4, rtol=1e-5, err_msg=k)
    jval = jctx.train.local_validation_metrics[-1]["metrics"]
    tval = tctx.train.local_validation_metrics[-1]["metrics"]
    assert set(tval) == set(jval) == {"validation_loss"}
    np.testing.assert_allclose(tval["validation_loss"],
                               jval["validation_loss"], atol=1e-4)
    assert state.step == 4
    assert tctx.searcher.completed_metrics == [(4, pytest.approx(
        tval["validation_loss"]))]


def test_resume_from_continues_at_the_step_with_identical_params(tmp_path):
    ctx, _, state = _port_fit(tmp_path, 3, report_period=1)
    ctx.close()
    assert ctx.checkpoint.lineage() == ["trial0-step3"]
    saved = [t.detach().clone() for t in state.leaves()]

    # A fresh Trainer restores it and, at the op's length already, stops.
    ctx2, _, state2 = _port_fit(tmp_path, 3, resume_from="trial0-step3")
    ctx2.close()
    assert state2.step == 3
    assert ctx2.train.local_training_metrics == []
    for a, b in zip(state2.leaves(), saved):
        assert torch.equal(a.detach(), b)
    assert state2.opt_state[1]["count"] == 3

    # ... and trains on from step 3.
    ctx3, _, state3 = _port_fit(tmp_path, 5, resume_from="trial0-step3",
                                report_period=1)
    ctx3.close()
    assert [r["steps_completed"]
            for r in ctx3.train.local_training_metrics] == [4, 5]
    assert state3.step == 5 and state3.opt_state[1]["count"] == 5
    assert ctx3.checkpoint.lineage() == ["trial0-step5", "trial0-step3"]


def test_missing_resume_checkpoint_walks_the_lineage_back(tmp_path):
    ctx, _, _ = _port_fit(tmp_path, 2, report_period=1)
    ctx.close()
    ctx2, trainer, state = _port_fit(tmp_path, 2,
                                     resume_from="trial0-step9")
    ctx2.close()
    assert state.step == 2  # restored trial0-step2, the newest older one
    restores = [s for s in ctx2.tracer.local_spans
                if s["name"] == "harness.restore"]
    assert restores[0]["attrs"] == {"requested": "trial0-step9",
                                    "restored": "trial0-step2"}


def test_on_nan_rollback_rewinds_to_the_last_committed_checkpoint(tmp_path):
    ctx = tcore.init(max_length=4, checkpoint_dir=str(tmp_path / "ckpt"))
    trial = TorchGPT2(TTrialContext(core_context=ctx), numpy_params(),
                      poison_step=3)
    trial.health = {"on_nan": "rollback", "rollback_window": 1,
                    "max_rollbacks": 1}
    state = TTrainer(trial, core_context=ctx, device="cpu").fit(
        report_period=1, checkpoint_period=2)
    ctx.close()
    reports = ctx.train.local_training_metrics
    # Step 3 diverged; the state went back to step 2's checkpoint and
    # steps 3 and 4 ran again on fresh batches (one skipped).
    assert [r["steps_completed"] for r in reports] == [1, 2, 3, 3, 4]
    assert reports[2]["metrics"]["divergence"] == 1.0
    assert reports[2]["metrics"]["all_finite"] == 0.0
    assert all(r["metrics"]["all_finite"] == 1.0 for r in reports[3:])
    assert trial.batches_drawn == 6  # 3 + 1 skipped + 2 replayed
    assert state.step == 4
    assert all(torch.isfinite(t).all() for t in state.leaves())
    assert ctx.checkpoint.lineage() == ["trial0-step4", "trial0-step2"]


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


@pytest.mark.parametrize("var", ["DET_MASTER", "DET_TRIAL_ID",
                                 "DET_ALLOCATION_ID"])
def test_core_init_refuses_a_cluster_environment(monkeypatch, var):
    monkeypatch.setenv(var, "1")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcore.init(max_length=1)


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
        def __init__(self, timeout_sec):
            super().__init__(timeout_sec, exit_fn=fired.append,
                             stream=io.StringIO())

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
