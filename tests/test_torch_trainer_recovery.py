"""The port's Trainer against the JAX Trainer's losses, and its recovery
paths: resume_from, a missing checkpoint walked back through the lineage,
and health.on_nan rollback with the prefetcher off and on.

These are test_torch_trainer.py's checks; its trials and helpers are
imported from there."""

import jax
import numpy as np
import pytest
import torch

from determined_tpu import core as jcore
from determined_tpu.train import Trainer as JTrainer
from determined_tpu.train.trial import TrialContext as JTrialContext
from determined_tpu_torch import core as tcore
from determined_tpu_torch.train import Trainer as TTrainer
from determined_tpu_torch.train.trial import TrialContext as TTrialContext
from test_torch_trainer import (  # noqa: F401 (fixtures)
    numpy_params,
    JaxGPT2,
    TorchGPT2,
    _port_fit,
)


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
        assert set(t["metrics"]) == set(j["metrics"])
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


@pytest.mark.parametrize("prefetch", [False, True],
                         ids=["prefetch_off", "prefetch_on"])
def test_on_nan_rollback_rewinds_to_the_last_committed_checkpoint(
        tmp_path, prefetch):
    ctx = tcore.init(max_length=4, checkpoint_dir=str(tmp_path / "ckpt"))
    trial = TorchGPT2(TTrialContext(core_context=ctx), numpy_params(),
                      poison_step=3)
    trial.prefetch = prefetch
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
    # Batch 4 skipped, 5 and 6 replayed, through the prefetcher or not.
    assert trial.batches_stepped == [1, 2, 3, 5, 6]
    if not prefetch:  # with it on, the producer draws ahead of the loop
        assert trial.batches_drawn == 6
    assert state.step == 4
    assert all(torch.isfinite(t).all() for t in state.leaves())
    assert ctx.checkpoint.lineage() == ["trial0-step4", "trial0-step2"]
