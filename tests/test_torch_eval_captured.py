"""`Trainer.fit`'s eval step: the captured route, on the CPU.

On CUDA `fit` runs `make_captured_eval_step` (one CUDA graph a batch
shape, replayed; a replay's outputs are its graph's, which the next
replay overwrites); on the CPU the same step object runs its plain
version, whose outputs are kept for the batch's shapes and overwritten
alike. Here:

  - Validation parity through `fit` (4 steps, a pass every 2, one process)
    against the JAX Trainer on one CPU device: tiny fp32 GPT-2 and the
    stateful ResNet trial (CIFAR stem at 8x8, its running BatchNorm stats
    in `extra`), numpy-drawn. The validation set has 2 batch shapes with
    different values in every batch (4, 4, 2, 2 rows), so a loop that
    kept a step's output tensor itself as its running sum, which the next
    call of that shape overwrites, would report another mean. Every
    validation metric atol 1e-5, rtol 1e-5 (the same arithmetic in
    another summation order).
  - The route rides keys of its own: the eval step's `harness.compile`
    span and the flush after its first call carry `eval_captured` and
    `eval_route`, and the first flush's `step_captured` and `step_route`
    stay the train step's.
  - The outputs contract itself: two calls of one shape return the same
    tensors, the second call's values.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from determined_tpu import core as jcore
from determined_tpu.models import gpt2 as jgpt2
from determined_tpu.models import resnet as jresnet
from determined_tpu.train import Trainer as JTrainer
from determined_tpu.train.trial import TrialContext as JTrialContext
from determined_tpu_torch import core as tcore
from determined_tpu_torch.models import gpt2 as tgpt2
from determined_tpu_torch.models import resnet as tresnet
from determined_tpu_torch.train import Trainer as TTrainer
from determined_tpu_torch.train import step as step_mod
from determined_tpu_torch.train.trial import TrialContext as TTrialContext
from test_torch_fit_captured import JaxGPT2, JaxResNet, TorchGPT2, TorchResNet
from test_torch_trainer import DIMS

STEPS, VAL_PERIOD = 4, 2
VAL_ROWS = (4, 4, 2, 2)   # two batch shapes, each twice


def gpt2_val(seed=7):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, DIMS["vocab_size"], size=(b, 17))
             .astype(np.int32)} for b in VAL_ROWS]


def resnet_val(seed=8):
    rng = np.random.default_rng(seed)
    return [{"images": rng.normal(size=(b, 8, 8, 3)).astype(np.float32),
             "labels": rng.integers(0, 5, b).astype(np.int32)}
            for b in VAL_ROWS]


class JaxGPT2Eval(JaxGPT2):
    def evaluate(self, params, batch):
        return {"validation_loss": jgpt2.loss_fn(params, batch, self.cfg)}

    def build_validation_data(self):
        return gpt2_val()


class TorchGPT2Eval(TorchGPT2):
    def evaluate(self, params, batch):
        return {"validation_loss": tgpt2.loss_fn(params, batch, self.cfg)}

    def build_validation_data(self):
        return gpt2_val()


class JaxResNetEval(JaxResNet):
    def evaluate(self, params, extra, batch):
        loss, aux, _ = jresnet.loss_fn(params, extra, batch, None, self.cfg,
                                       train=False)
        return {"validation_loss": loss, "accuracy": aux["accuracy"]}

    def build_validation_data(self):
        return resnet_val()


class TorchResNetEval(TorchResNet):
    def evaluate(self, params, extra, batch):
        loss, aux, _ = tresnet.loss_fn(params, extra, batch, None, self.cfg,
                                       train=False)
        return {"validation_loss": loss, "accuracy": aux["accuracy"]}

    def build_validation_data(self):
        return resnet_val()


def fit(core, trainer_cls, ctx_cls, trial_cls, tmp_path, name, **kw):
    """A fit of STEPS steps, validating every VAL_PERIOD -> (the core
    context, the trainer)."""
    ctx = core.init(max_length=STEPS, checkpoint_dir=str(tmp_path / name))
    trainer = trainer_cls(trial_cls(ctx_cls(core_context=ctx)),
                          core_context=ctx, **kw)
    trainer.fit(report_period=1, validation_period=VAL_PERIOD)
    ctx.tracer.flush()
    ctx.close()
    return ctx, trainer


RUNS = {"gpt2": (JaxGPT2Eval, TorchGPT2Eval),
        "resnet_stateful": (JaxResNetEval, TorchResNetEval)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each trial's fit through both Trainers, the JAX fits (mostly XLA
    compiles) on a thread beside the port's -> {name: (jax ctx, port ctx,
    port trainer)}."""
    tmp = tmp_path_factory.mktemp("eval_captured")
    out = {}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_fits = {name: pool.submit(
            fit, jcore, JTrainer, JTrialContext, j, tmp, f"jax_{name}",
            devices=jax.devices()[:1]) for name, (j, _) in RUNS.items()}
        for name, (_, t) in RUNS.items():
            out[name] = fit(tcore, TTrainer, TTrialContext, t, tmp,
                            f"torch_{name}", device="cpu")
        return {name: (jax_fits[name].result()[0],) + out[name]
                for name in RUNS}


@pytest.mark.parametrize("name", list(RUNS))
def test_validation_matches_the_jax_trainer(runs, name):
    jctx, tctx, trainer = runs[name]
    assert isinstance(trainer._eval_step, step_mod._CapturedEvalStep)
    jval = jctx.train.local_validation_metrics
    tval = tctx.train.local_validation_metrics
    assert [r["steps_completed"] for r in tval] == \
        [r["steps_completed"] for r in jval] == [2, 4]
    for t, j in zip(tval, jval):
        assert set(t["metrics"]) == set(j["metrics"])
        for k, want in j["metrics"].items():
            np.testing.assert_allclose(t["metrics"][k], want, atol=1e-5,
                                       rtol=1e-5, err_msg=k)
    # Two shapes: the plain version kept two sets of outputs.
    assert len(trainer._eval_step._outputs) == 2


def test_the_eval_route_rides_keys_of_its_own(runs):
    _, tctx, _ = runs["gpt2"]
    flushes = [r["metrics"] for r in tctx.train.local_training_metrics]
    assert [r["steps_completed"] for r in
            tctx.train.local_training_metrics] == [1, 2, 3, 4]
    # The train step's first call lands in the first flush, the eval
    # step's (the pass at step 2) in the flush after it.
    assert flushes[0]["step_captured"] == 0.0
    assert flushes[0]["step_route"].startswith("plain: ")
    assert "eval_route" not in flushes[0]
    assert flushes[2]["eval_captured"] == 0.0
    assert flushes[2]["eval_route"].startswith("plain: on the CPU the "
                                               "captured eval step")
    assert "step_route" not in flushes[2]
    assert not any("eval_route" in f for i, f in enumerate(flushes)
                   if i != 2)
    spans = {s["attrs"]["executable"]: s["attrs"]
             for s in tctx.tracer.local_spans
             if s["name"] == "harness.compile"}
    assert set(spans) == {"train_step", "eval_step"}
    assert spans["train_step"]["step_route"].startswith("plain: ")
    assert "eval_route" not in spans["train_step"]
    assert spans["eval_step"]["eval_route"] == flushes[2]["eval_route"]
    assert "step_route" not in spans["eval_step"]


def test_a_call_overwrites_the_outputs_of_its_shape(runs):
    _, _, trainer = runs["gpt2"]
    step = step_mod.make_captured_eval_step(trainer.trial.evaluate)
    a, b, c = (torch.from_numpy(x["tokens"]) for x in gpt2_val()[:3])
    first = step(trainer.state, {"tokens": a})["validation_loss"]
    value = float(first)
    second = step(trainer.state, {"tokens": b})["validation_loss"]
    assert first is second and float(first) != value
    # Another shape has outputs of its own.
    other = step(trainer.state, {"tokens": c})["validation_loss"]
    assert other is not first and float(first) == float(second)
