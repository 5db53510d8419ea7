"""The port's ResNet and stateful training against the JAX package, on
the CPU.

Model cases, numpy-drawn params and running stats in the JAX layout
(`params_from_numpy`: HWIO kernels to OIHW) at a tiny width, `stage_sizes`
(1, 1) as tests/test_models.py uses:

- "basic": the CIFAR stem at 8x8; the stride-2 3x3 conv on an even size
  pads (0, 1).
- "bottleneck": the ImageNet stem at 32x32, so every asymmetric SAME
  padding runs: the 7x7 stride-2 stem pads (2, 3), the 3x3 stride-2
  max-pool (0, 1) with -inf, the stride-2 3x3 conv (0, 1).

Each checks the logits and new batch stats in train and eval mode, the
loss and every gradient against `jax.grad`. Tolerances, fp32: logits
within 1e-5 of the largest logit, stats within 1e-6 of the largest stat,
gradients within 1e-5 of each leaf's largest element ("basic"). In
"bottleneck", JAX's own fp32 gradients are up to 1.5e-5 of a leaf's
largest element from an fp64 evaluation of the same function (the
port's, in float64), so the port is held to JAX at 3e-5 and its fp32
gradients to its fp64 ones at 1e-5. bf16 ("bottleneck"): logits within
2e-2 of the largest, stats 1e-2: bf16 rounds each activation to 8 bits,
in other places in XLA's fusions than in eager torch.

Then the stateful protocol through the Trainer and the step:

- `fit` at world 1 against the JAX Trainer (losses rtol 1e-5, the final
  batch stats, the validation loss on the running stats), and the
  checkpoint's `extra` restored bit-identical;
- `make_multi_step` against N `make_train_step`s (bitwise, stats
  included), the stats staying the state's own buffers;
- the refusal of `tensor`, `context` and `expert` above 1 for a trial
  that says its model splits no work (`supports_model_parallel()`
  False), word for word.

The world-2 run over `data` is in test_torch_resnet_data2.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from determined_tpu import core as jcore
from determined_tpu.models import resnet as jresnet
from determined_tpu.train import JaxTrial
from determined_tpu.train import Trainer as JTrainer
from determined_tpu.train.trial import TrialContext as JTrialContext
from determined_tpu_torch import core as tcore
from determined_tpu_torch.models import _conv
from determined_tpu_torch.models.gpt2 import map_params
from determined_tpu_torch.models import resnet as tresnet
from determined_tpu_torch.train import TorchTrial
from determined_tpu_torch.train import Trainer as TTrainer
from determined_tpu_torch.train import optim
from determined_tpu_torch.train.state import create_train_state
from determined_tpu_torch.train.step import make_multi_step, make_train_step
from determined_tpu_torch.train.trial import TrialContext as TTrialContext

CASES = {"basic": dict(bottleneck=False, cifar_stem=True, size=8),
         "bottleneck": dict(bottleneck=True, cifar_stem=False, size=32)}
DIMS = dict(stage_sizes=(1, 1), num_filters=8, n_classes=5)
FIT_STEPS, GLOBAL_BATCH, LR = 5, 8, 0.1
# Jitted: op-by-op JAX takes several times longer here.
japply = jax.jit(jresnet.apply, static_argnums=(3, 4))


def configs(case, dtype="f32"):
    c = CASES[case]
    kw = dict(DIMS, bottleneck=c["bottleneck"], cifar_stem=c["cifar_stem"])
    return (jresnet.Config(**kw, dtype={"f32": jnp.float32,
                                        "bf16": jnp.bfloat16}[dtype]),
            tresnet.Config(**kw, dtype={"f32": torch.float32,
                                        "bf16": torch.bfloat16}[dtype]))


def numpy_state(case, seed=0):
    """(params, batch_stats) in the JAX layout: init's shapes, the kernels
    and the head drawn wider than init, scale 1 + noise, variances > 0."""
    jcfg, _ = configs(case)
    params, stats = jax.eval_shape(lambda r: jresnet.init(r, jcfg),
                                   jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        base = 1.0 if ("scale" in name or "var" in name) else 0.0
        x = rng.normal(size=s.shape) * (0.3 if "kernel" in name else 0.1)
        if "var" in name:
            x = np.abs(x)
        return (base + x).astype(np.float32)

    return (jax.tree_util.tree_map_with_path(leaf, params),
            jax.tree_util.tree_map_with_path(leaf, stats))


def batch_for(case, n=4, seed=1):
    rng = np.random.default_rng(seed)
    s = CASES[case]["size"]
    return {"images": rng.normal(size=(n, s, s, 3)).astype(np.float32),
            "labels": rng.integers(0, DIMS["n_classes"], n).astype(np.int32)}


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_trees(got, want, rel, what):
    got, want = flat(got), flat(want)
    assert set(got) == set(want), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=rel * max(np.abs(w).max(), 1e-30),
                                   err_msg=f"{what} {k}")


def assert_stats(got, want, rel):
    """Port stats within `rel` of the largest JAX stat."""
    want, got = flat(want), flat(tresnet.params_to_numpy(got))
    assert set(got) == set(want)
    top = max(np.abs(v).max() for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=rel * top,
                                   err_msg=k)


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def port_grads(params, stats, batch, cfg, dtype=torch.float32):
    """(loss, gradients in the JAX layout) of the port's loss_fn."""
    leaves = []

    def mark(t):
        t = t.to(dtype).requires_grad_(True)
        leaves.append(t)
        return t

    tp = map_params(mark, tresnet.params_from_numpy(params))
    ts = map_params(lambda t: t.to(dtype),
                          tresnet.params_from_numpy(stats))
    b = torch_batch(batch)
    b["images"] = b["images"].to(dtype)
    loss, _, _ = tresnet.loss_fn(tp, ts, b, cfg=cfg)
    it = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), tresnet.params_to_numpy(
        map_params(lambda t: next(it), tp))


# ------------------------------------------------------------- the model


@pytest.mark.parametrize("size, k, stride, pads", [
    (224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)), (56, 3, 2, (0, 1)),
    (8, 1, 2, (0, 0)), (32, 3, 1, (1, 1)), (7, 3, 2, (1, 1))])
def test_same_padding_is_xla_s(size, k, stride, pads):
    assert _conv.same_padding(size, k, stride) == pads
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, size, size, 2)).astype(np.float32)
    w = rng.normal(size=(k, k, 2, 3)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = _conv.conv2d_same(_conv.nchw(torch.from_numpy(x), torch.float32),
                            torch.from_numpy(_conv.to_oihw(w)), stride)
    np.testing.assert_allclose(_conv.nhwc(got).numpy(), np.asarray(want),
                               atol=1e-5 * np.abs(want).max())


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


def test_batch_norm_saves_no_fp32_copy_of_a_bf16_activation():
    x = torch.randn(4, 6, 5, 5, dtype=torch.bfloat16, requires_grad=True)
    p = {"scale": torch.ones(6, requires_grad=True),
         "bias": torch.zeros(6, requires_grad=True)}
    st = {"mean": torch.zeros(6), "var": torch.ones(6)}
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        y, _ = tresnet.batch_norm(x, p, st, tresnet.Config(), True, [], 1)
    big = [t for t in saved if t.numel() == x.numel()]
    assert big and all(t.dtype == torch.bfloat16 for t in big)
    y.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16


# ----------------------------------------------------- the stateful trial


def fit_batches(n=FIT_STEPS, seed=3):
    rng = np.random.default_rng(seed)
    return [{"images": rng.normal(size=(GLOBAL_BATCH, 8, 8, 3))
             .astype(np.float32),
             "labels": rng.integers(0, DIMS["n_classes"], GLOBAL_BATCH)
             .astype(np.int32)} for _ in range(n)]


class JaxResNet(JaxTrial):
    stateful = True

    def __init__(self, context, state, batches):
        super().__init__(context)
        self.cfg = configs("basic")[0]
        self.state, self.batches = state, batches

    def init_params(self, rng):
        return jax.tree_util.tree_map(jnp.asarray, self.state[0])

    def init_extra(self):
        return jax.tree_util.tree_map(jnp.asarray, self.state[1])

    def loss(self, params, extra, batch, rng):
        return jresnet.loss_fn(params, extra, batch, rng, self.cfg)

    def optimizer(self):
        return optax.sgd(LR, momentum=0.9)

    def build_training_data(self):
        return self.batches

    def build_validation_data(self):
        return fit_batches(2, seed=4)

    def evaluate(self, params, extra, batch):
        loss, aux, _ = jresnet.loss_fn(params, extra, batch, None, self.cfg,
                                       train=False)
        return {"validation_loss": loss, "accuracy": aux["accuracy"]}


class TorchResNet(TorchTrial):
    stateful = True

    def __init__(self, context, state, batches):
        super().__init__(context)
        self.cfg = configs("basic")[1]
        self.state, self.batches = state, batches

    def init_params(self, rng):
        return tresnet.params_from_numpy(self.state[0], rng.device)

    def init_extra(self):
        return tresnet.params_from_numpy(self.state[1])

    def loss(self, params, extra, batch, rng):
        return tresnet.loss_fn(params, extra, batch, rng, self.cfg)

    def supports_model_parallel(self):
        return False

    def optimizer(self):
        return optim.sgd(LR, momentum=0.9)

    def build_training_data(self):
        return self.batches

    def build_validation_data(self):
        return fit_batches(2, seed=4)

    def evaluate(self, params, extra, batch):
        loss, aux, _ = tresnet.loss_fn(params, extra, batch, None, self.cfg,
                                       train=False)
        return {"validation_loss": loss, "accuracy": aux["accuracy"]}


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


def _leaves(tree):
    from determined_tpu_torch.train.state import extra_leaves

    return extra_leaves(tree)


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


@pytest.mark.parametrize("axes", [{"tensor": 2}, {"context": 2},
                                  {"expert": 2}])
def test_the_model_axes_are_refused_before_any_state(tmp_path, axes):
    class Split(TorchResNet):
        def mesh_config(self):
            from determined_tpu_torch.parallel.mesh import MeshConfig

            return MeshConfig(data=1, **axes)

    ctx = tcore.init(max_length=1, checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError) as e:
        TTrainer(Split(TTrialContext(core_context=ctx),
                       numpy_state("basic"), fit_batches(1)),
                 core_context=ctx, device="cpu")
    ctx.close()
    assert str(e.value) == (
        f"Split asks for the mesh axes {axes}; its model splits no work "
        "over tensor, context or expert (supports_model_parallel() is "
        "False), so the port trains it over data and fsdp only; split the "
        "model's work over those axes (as models/mnist.py, resnet.py and "
        "diffusion.py do) and drop the override")
