"""ResNet's forward, loss and gradients against the JAX model (jax.grad),
in fp32 and bf16, and its stateful training against the JAX Trainer and
as replayed steps.

These are test_torch_resnet.py's checks that run the JAX side or train;
its helpers are imported from there."""

import jax
import numpy as np
import pytest
import torch

from determined_tpu import core as jcore
from determined_tpu.models import resnet as jresnet
from determined_tpu.train import Trainer as JTrainer
from determined_tpu.train.trial import TrialContext as JTrialContext
from determined_tpu_torch import core as tcore
from determined_tpu_torch.models import resnet as tresnet
from determined_tpu_torch.train import Trainer as TTrainer
from determined_tpu_torch.train import optim
from determined_tpu_torch.train.state import create_train_state
from determined_tpu_torch.train.step import make_multi_step, make_train_step
from determined_tpu_torch.train.trial import TrialContext as TTrialContext
from test_torch_resnet import (  # noqa: F401 (fixtures)
    CASES,
    FIT_STEPS,
    LR,
    japply,
    configs,
    numpy_state,
    batch_for,
    assert_trees,
    assert_stats,
    torch_batch,
    port_grads,
    fit_batches,
    JaxResNet,
    TorchResNet,
    _leaves,
)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_apply_matches_jax(case, train):
    jcfg, tcfg = configs(case)
    params, stats = numpy_state(case)
    images = batch_for(case)["images"]
    jl, jst = japply(params, stats, images, jcfg, train)
    tl, tst = tresnet.apply(tresnet.params_from_numpy(params),
                            tresnet.params_from_numpy(stats),
                            torch.from_numpy(images), tcfg, train=train)
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.detach().numpy(), jl, rtol=0,
                               atol=1e-5 * np.abs(jl).max())
    assert_stats(tst, jst, 1e-6)


def test_bf16_apply_matches_jax():
    jcfg, tcfg = configs("bottleneck", "bf16")
    params, stats = numpy_state("bottleneck")
    images = batch_for("bottleneck")["images"]
    for train in (True, False):
        jl, jst = japply(params, stats, images, jcfg, train)
        tl, tst = tresnet.apply(tresnet.params_from_numpy(params),
                                tresnet.params_from_numpy(stats),
                                torch.from_numpy(images), tcfg, train=train)
        assert tl.dtype == torch.float32
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.detach().numpy(), jl, rtol=0,
                                   atol=2e-2 * np.abs(jl).max())
        assert_stats(tst, jst, 1e-2)


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_every_gradient_match_jax_grad(case):
    jcfg, tcfg = configs(case)
    params, stats = numpy_state(case)
    batch = batch_for(case)
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p: jresnet.loss_fn(p, stats, batch, cfg=jcfg)[0]))(params)
    loss, grads = port_grads(params, stats, batch, tcfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    if case == "basic":
        assert_trees(grads, jg, 1e-5, "grad vs JAX")
        return
    assert_trees(grads, jg, 3e-5, "grad vs JAX")
    f64 = tresnet.Config(**{**tcfg.__dict__, "dtype": torch.float64,
                            "param_dtype": torch.float64})
    _, grads64 = port_grads(params, stats, batch, f64, torch.float64)
    assert_trees(grads, grads64, 1e-5, "fp32 vs fp64")


def test_stateful_fit_matches_the_jax_trainer_and_restores_extra(tmp_path):
    state, batches = numpy_state("basic"), fit_batches()
    jctx = jcore.init(max_length=FIT_STEPS,
                      checkpoint_dir=str(tmp_path / "jax"))
    jtrainer = JTrainer(JaxResNet(JTrialContext(core_context=jctx), state,
                                  batches),
                        core_context=jctx, devices=jax.devices()[:1])
    jfinal = jtrainer.fit(report_period=1)
    jctx.close()
    tctx = tcore.init(max_length=FIT_STEPS,
                      checkpoint_dir=str(tmp_path / "port"))
    trainer = TTrainer(TorchResNet(TTrialContext(core_context=tctx), state,
                                   batches), core_context=tctx, device="cpu")
    tfinal = trainer.fit(report_period=1)

    jrep = [r["metrics"] for r in jctx.train.local_training_metrics]
    trep = [r["metrics"] for r in tctx.train.local_training_metrics]
    np.testing.assert_allclose([r["loss"] for r in trep],
                               [r["loss"] for r in jrep], rtol=1e-5)
    assert_trees(tresnet.params_to_numpy(tfinal.extra),
                 jax.device_get(jfinal.extra), 1e-5, "final stats")
    jval = jctx.train.local_validation_metrics[-1]["metrics"]
    tval = tctx.train.local_validation_metrics[-1]["metrics"]
    for k in ("validation_loss", "validation_accuracy"):
        np.testing.assert_allclose(tval[k], jval[k], rtol=1e-5, err_msg=k)

    ids = [r["uuid"] for r in tctx.checkpoint.local_reported]
    assert ids == [f"trial0-step{FIT_STEPS}"]
    template = create_train_state(
        trainer.trial.init_params, trainer._tx,
        torch.Generator().manual_seed(0), device="cpu",
        extra=trainer.trial.init_extra())
    back = tctx.checkpoint.restore_state(ids[0], template)
    tctx.close()
    assert back.step == FIT_STEPS
    for a, b in zip(_leaves(back.extra), _leaves(tfinal.extra)):
        assert torch.equal(a, b)
    for a, b in zip(back.leaves(), tfinal.leaves()):
        assert torch.equal(a, b)
    for a, b in zip(back.opt_state["trace"], tfinal.opt_state["trace"]):
        assert torch.equal(a, b)


def test_multi_step_replays_stateful_steps_like_single_steps():
    params, stats = numpy_state("basic")
    cfg = configs("basic")[1]
    batches = fit_batches(3)

    def loss(p, extra, batch, rng):
        return tresnet.loss_fn(p, extra, batch, rng, cfg)

    def fresh():
        tx = optim.sgd(LR, momentum=0.9)
        return tx, create_train_state(
            lambda g: tresnet.params_from_numpy(params), tx,
            torch.Generator().manual_seed(0), device="cpu",
            extra=tresnet.params_from_numpy(stats))

    tx, one = fresh()
    buffers = [t.data_ptr() for t in _leaves(one.extra)]
    step = make_train_step(loss, tx, stateful=True)
    losses = []
    for b in batches:
        one, m = step(one, torch_batch(b), None)
        losses.append(float(m["loss"]))
    assert [t.data_ptr() for t in _leaves(one.extra)] == buffers
    tx, multi = fresh()
    window = {k: torch.from_numpy(np.stack([b[k] for b in batches]))
              for k in batches[0]}
    multi, mm = make_multi_step(loss, tx, 3, stateful=True)(multi, window,
                                                            None)
    assert multi.step == one.step == 3
    assert float(mm["loss"]) == pytest.approx(np.mean(losses), rel=1e-6)
    for a, b in zip(_leaves(multi.extra), _leaves(one.extra)):
        assert torch.equal(a, b)
    for a, b in zip(multi.leaves(), one.leaves()):
        assert torch.equal(a, b)
    # The stats moved: the three steps each wrote the buffers.
    init = _leaves(tresnet.params_from_numpy(stats))
    assert not all(torch.equal(a, b) for a, b in zip(init,
                                                     _leaves(one.extra)))
