"""The port's SGD and MNIST CNN against optax and the JAX package, on the
CPU.

- `optim.sgd` against `optax.sgd` over 5 updates of the same gradients:
  without momentum, with momentum, with nesterov, and with a schedule.
  Tolerance: rtol 1e-6 (the same fp32 products, one rounding each).
- `models/mnist.py`'s `apply`, loss and every gradient against the JAX
  functions and `jax.grad` on numpy-drawn params in the JAX layout
  (`params_from_numpy` turns HWIO kernels into OIHW; `fc1`'s rows run
  (h, w, c)): fp32, forward within 1e-5 of the largest logit, each
  gradient leaf within 1e-5 of its largest element.
- The example trial (examples/mnist_cuda/model_def.py) through the port's
  `Trainer.fit`, local, 20 steps, against the JAX example's `MNistTrial`
  under the JAX Trainer, both from the same numpy params: every step's
  loss rtol 1e-5, the op-end validation loss and accuracy likewise.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from determined_tpu import core as jcore
from determined_tpu.models import mnist as jmnist
from determined_tpu.train import Trainer as JTrainer
from determined_tpu.train.trial import TrialContext as JTrialContext
from determined_tpu_torch import core as tcore
from determined_tpu_torch.models import mnist as tmnist
from determined_tpu_torch.train import Trainer as TTrainer
from determined_tpu_torch.train import optim
from determined_tpu_torch.train.trial import TrialContext as TTrialContext

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIT_STEPS = 20


def load_example(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def leaves_with_paths(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


# ------------------------------------------------------------------- sgd


@pytest.mark.parametrize("lr, momentum, nesterov", [
    (0.1, None, False),
    (0.1, 0.9, False),
    (0.1, 0.9, True),
    (optax.linear_schedule(0.2, 0.01, 4), 0.5, False),
], ids=["plain", "momentum", "nesterov", "schedule"])
def test_sgd_matches_optax(lr, momentum, nesterov):
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 3, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    tlr = lr
    if callable(lr):
        tlr = optim.linear_schedule(0.2, 0.01, 4)
    jtx = optax.sgd(lr, momentum=momentum, nesterov=nesterov)
    ttx = optim.sgd(tlr, momentum=momentum, nesterov=nesterov)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p.copy()) for p in params]
    hp = [torch.from_numpy(p.copy()) for p in params]  # fed `hyper`
    js, ts, hs = jtx.init(jp), ttx.init(tp), ttx.init(hp)
    for g in grads:
        ju, js = jtx.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update([torch.from_numpy(x.copy()) for x in g], ts, tp)
        optim.apply_updates(tp, tu)
        # A replayed step's form: the host floats as a tensor.
        floats, after = ttx.hyper(hs)
        hu, hs = ttx.update([torch.from_numpy(x.copy()) for x in g], hs, hp,
                            hyper=torch.tensor(floats))
        assert hs["count"] == after["count"]
        optim.apply_updates(hp, hu)
    for j, t, h in zip(jp, tp, hp):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-7)
        assert torch.equal(t, h)


# ----------------------------------------------------------------- model


@pytest.fixture(scope="module")
def jax_mnist():
    """Numpy params in the JAX layout (wider than he_normal's, so the
    logits spread) and a batch."""
    cfg = jmnist.Config(hidden=32)
    shapes = jax.eval_shape(lambda r: jmnist.init(r, cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda s: (0.1 * rng.normal(size=s.shape)).astype(np.float32), shapes)
    images = rng.normal(size=(6, 28, 28, 1)).astype(np.float32)
    labels = rng.integers(0, 10, 6).astype(np.int32)
    return cfg, params, {"images": images, "labels": labels}


def test_apply_loss_and_grad_match_jax(jax_mnist):
    jcfg, params, batch = jax_mnist
    tcfg = tmnist.Config(hidden=32)
    want = np.asarray(jmnist.apply(params, batch["images"], jcfg))
    tp = tmnist.params_from_numpy(params)
    assert tp["conv2"]["kernel"].shape == (64, 32, 3, 3)  # OIHW
    got = tmnist.apply(tp, torch.from_numpy(batch["images"]), tcfg)
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=1e-5 * np.abs(want).max(), rtol=0)

    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jmnist.loss_fn(p, batch, jcfg), has_aux=True)(params)
    leaves = []

    def mark(t):
        leaves.append(t.requires_grad_(True))
        return t

    tp = {k: {n: mark(v) for n, v in d.items()} for k, d in tp.items()}
    tl, taux = tmnist.loss_fn(tp, {k: torch.from_numpy(v)
                                   for k, v in batch.items()}, tcfg)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    assert float(taux["accuracy"]) == float(jaux["accuracy"])
    grads = iter(torch.autograd.grad(tl, leaves))
    tg = tmnist.params_to_numpy(
        {k: {n: next(grads) for n in d} for k, d in tp.items()})
    want_g, got_g = leaves_with_paths(jg), leaves_with_paths(tg)
    assert set(want_g) == set(got_g)
    for k, w in want_g.items():
        np.testing.assert_allclose(got_g[k], w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)


def test_fc1_rows_run_h_w_c():
    """A kernel that reads one NHWC position sees that position: the port
    flattens the activation in the JAX model's (h, w, c) order."""
    cfg = tmnist.Config(c1=2, c2=3, hidden=4)
    p = tmnist.init(torch.Generator().manual_seed(0), cfg)
    with torch.no_grad():
        for k in ("conv1", "conv2"):
            p[k]["kernel"].zero_()
            p[k]["bias"].zero_()
        p["conv2"]["bias"][2] = 1.0          # only channel 2 is nonzero
        p["fc1"]["kernel"].zero_()
        # Row (h 0, w 0, c 2); an NCHW flatten reads row 2 as channel 0.
        p["fc1"]["kernel"][2, 0] = 1.0
        p["fc1"]["bias"].zero_()
        p["fc2"]["kernel"].copy_(torch.eye(4, 10))
        p["fc2"]["bias"].zero_()
    out = tmnist.apply(p, torch.zeros(1, 28, 28, 1), cfg)
    assert out[0, 0] == 1.0 and float(out[0, 1:].abs().sum()) == 0.0


# ------------------------------------------------------------------ fit


def test_example_trial_fit_matches_the_jax_example(tmp_path, jax_mnist):
    jex = load_example("examples/mnist/model_def.py", "jax_mnist_example")
    tex = load_example("examples/mnist_cuda/model_def.py",
                       "torch_mnist_example")
    hp = {"learning_rate": 0.05, "hidden": 32, "global_batch_size": 16}
    _, params, _ = jax_mnist

    class JTrial(jex.MNistTrial):
        def init_params(self, rng):
            return jax.tree_util.tree_map(jnp.asarray, params)

    class TTrial(tex.MNistTrial):
        def init_params(self, rng):
            return tmnist.params_from_numpy(params, rng.device)

    jctx = jcore.init(max_length=FIT_STEPS,
                      checkpoint_dir=str(tmp_path / "jax"))
    JTrainer(JTrial(JTrialContext(hparams=hp, core_context=jctx)),
             core_context=jctx, devices=jax.devices()[:1]).fit(
        report_period=1)
    jctx.close()
    tctx = tcore.init(max_length=FIT_STEPS,
                      checkpoint_dir=str(tmp_path / "port"))
    state = TTrainer(TTrial(TTrialContext(hparams=hp, core_context=tctx)),
                     core_context=tctx, device="cpu").fit(report_period=1)
    tctx.close()

    jrep = [r["metrics"] for r in jctx.train.local_training_metrics]
    trep = [r["metrics"] for r in tctx.train.local_training_metrics]
    assert len(jrep) == len(trep) == FIT_STEPS and state.step == FIT_STEPS
    np.testing.assert_allclose([r["loss"] for r in trep],
                               [r["loss"] for r in jrep], rtol=1e-5)
    assert trep[-1]["loss"] < trep[0]["loss"]
    jval = jctx.train.local_validation_metrics[-1]["metrics"]
    tval = tctx.train.local_validation_metrics[-1]["metrics"]
    assert set(tval) == set(jval) == {"validation_loss",
                                      "validation_accuracy"}
    for k in jval:
        np.testing.assert_allclose(tval[k], jval[k], rtol=1e-5, err_msg=k)
