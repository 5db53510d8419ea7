"""The port's DDPM UNet and diffusion example against the JAX package, on
the CPU, at `Config.tiny()` (16px, widths 16/32, fp32, 64 timesteps).

Numpy-drawn params in the JAX layout (HWIO kernels, levels as lists)
reach the port through `params_from_numpy`. Checked:

- `apply` at given timesteps: within 1e-5 of the largest output;
- `loss_from_noise` (the JAX `loss_fn`'s formula at given t and eps) and
  every gradient against `jax.grad`: loss rtol 1e-6, each leaf within
  1e-5 of its largest element;
- one reverse step of `sample` (`reverse_step`) with given noise, against
  the JAX formula built here from `diffusion.apply` and `alpha_bars`:
  within 1e-5 of the largest element; and `sample`'s eager loop (4
  timesteps) from a seed: in [-1, 1], the same for the same seed;
- the example trial (examples/diffusion_cuda/model_def.py) through the
  port's `Trainer.fit`, 4 steps, against the JAX example's
  `DiffusionTrial` under the JAX Trainer, with the timesteps and noise
  supplied in the batches on both sides: losses and the validation loss
  rtol 1e-5, grad norms 5e-5 (adamw turns each side's fp32 rounding in
  a near-zero gradient into a step of about lr);
- a JAX `pretrain.py` params pickle (the JAX example's `save_params`)
  through the port's `load_params` and `pretrained_path`: the same
  `apply`; the port's `save_params` read by the JAX `load_params`; the
  `pretrained_path` refusals word for word.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from determined_tpu import core as jcore
from determined_tpu.models import diffusion as jdiff
from determined_tpu.train import Trainer as JTrainer
from determined_tpu.train.trial import TrialContext as JTrialContext
from determined_tpu_torch import core as tcore
from determined_tpu_torch.models import _conv
from determined_tpu_torch.models.gpt2 import map_params
from determined_tpu_torch.models import diffusion as tdiff
from determined_tpu_torch.train import Trainer as TTrainer
from determined_tpu_torch.train.trial import TrialContext as TTrialContext

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG, TCFG = jdiff.Config.tiny(), tdiff.Config.tiny()
B, FIT_STEPS = 4, 4
# Jitted: op-by-op JAX takes ~10x longer here.
japply = jax.jit(jdiff.apply, static_argnums=3)


def load_example(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


@pytest.fixture(scope="module")
def setup():
    """JAX-layout numpy params (init's shapes; kernels drawn at init's
    scale, the output conv nonzero, norms 1 + noise), images, t, eps."""
    shapes = jax.eval_shape(lambda r: jdiff.init(r, JCFG),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return (1 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        fan = np.prod(s.shape[:-1]) if len(s.shape) > 1 else 10
        return (rng.normal(size=s.shape) / np.sqrt(fan)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    size = JCFG.image_size
    images = rng.uniform(-1, 1, (B, size, size, 3)).astype(np.float32)
    t = rng.integers(0, JCFG.timesteps, B).astype(np.int32)
    eps = rng.normal(size=images.shape).astype(np.float32)
    return params, images, t, eps


def test_levels_and_kernels_change_layout(setup):
    params = setup[0]
    tp = tdiff.params_from_numpy(params)
    assert set(tp["down"]) == {"0", "1"} and set(tp["up"]) == {"0", "1"}
    k = tp["down"]["0"]["res"]["conv1"]["kernel"]
    assert k.shape == (16, 16, 3, 3)                      # OIHW
    axes = tdiff.param_logical_axes(TCFG)
    assert axes["down"]["0"]["res"]["conv1"]["kernel"] == \
        ("mlp", "embed", None, None)
    assert axes["conv_in"]["kernel"] == ("mlp", None, None, None)
    assert_trees(tdiff.params_to_numpy(tp), params, 0, "round trip")


def test_apply_matches_jax(setup):
    params, images, t, _ = setup
    want = np.asarray(japply(params, images, t, JCFG))
    got = tdiff.apply(tdiff.params_from_numpy(params),
                      torch.from_numpy(images), torch.from_numpy(t), TCFG)
    assert got.shape == images.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def jax_loss_from_noise(params, x0, t, eps):
    """The JAX loss_fn's body at given t and eps."""
    ab = jdiff.alpha_bars(JCFG)[t][:, None, None, None]
    xt = jnp.sqrt(ab) * x0 + jnp.sqrt(1.0 - ab) * eps
    return jnp.mean((jdiff.apply(params, xt, t, JCFG) - eps) ** 2)


def test_loss_from_noise_and_every_gradient_match_jax_grad(setup):
    params, images, t, eps = setup
    jl, jg = jax.jit(jax.value_and_grad(jax_loss_from_noise))(
        params, images, t, eps)
    leaves = []

    def mark(x):
        leaves.append(x.requires_grad_(True))
        return x

    tp = map_params(mark, tdiff.params_from_numpy(params))
    loss, aux = tdiff.loss_from_noise(tp, torch.from_numpy(images),
                                      torch.from_numpy(t),
                                      torch.from_numpy(eps), TCFG)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    assert aux["loss"] is loss
    it = iter(torch.autograd.grad(loss, leaves))
    grads = tdiff.params_to_numpy(map_params(lambda x: next(it), tp))
    assert_trees(grads, jg, 1e-5, "grad")


def test_reverse_step_matches_the_jax_formula(setup):
    params, images, _, eps = setup
    ab = jdiff.alpha_bars(JCFG)
    ab_prev = jnp.concatenate([jnp.ones((1,)), ab[:-1]])
    alphas = ab / ab_prev
    betas = 1.0 - alphas
    tp = tdiff.params_from_numpy(params)
    for t in (JCFG.timesteps - 1, 17, 0):
        tb = jnp.full((B,), t, jnp.int32)
        eps_hat = japply(params, images, tb, JCFG)
        coef = betas[t] / jnp.sqrt(1.0 - ab[t])
        mean = (images - coef * eps_hat) / jnp.sqrt(alphas[t])
        want = np.asarray(mean + jnp.where(t > 0, jnp.sqrt(betas[t]), 0.0)
                          * eps)
        got = tdiff.reverse_step(tp, torch.from_numpy(images),
                                 torch.tensor([t]), torch.from_numpy(eps),
                                 TCFG)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=f"t={t}")


def test_sample_eager_loop_is_bounded_and_seeded(setup):
    import dataclasses

    tp = tdiff.params_from_numpy(setup[0])
    cfg = dataclasses.replace(TCFG, timesteps=4)  # the loop, not its length
    a = tdiff.sample(tp, torch.Generator().manual_seed(3), 2, cfg)
    b = tdiff.sample(tp, torch.Generator().manual_seed(3), 2, cfg)
    assert a.shape == (2, 16, 16, 3)
    assert torch.equal(a, b)
    assert float(a.abs().max()) <= 1.0 and torch.isfinite(a).all()


# ------------------------------------------------------------ the example


HP = {"model_size": "tiny", "global_batch_size": B, "learning_rate": 1e-3,
      "grad_clip": 1.0, "weight_decay": 0.01}


def noisy_batches(images, seed, n):
    """Batches carrying their own timesteps and noise."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        idx = rng.integers(0, len(images), B)
        out.append({"images": images[idx],
                    "t": rng.integers(0, JCFG.timesteps, B).astype(np.int32),
                    "eps": rng.normal(size=(B, 16, 16, 3))
                    .astype(np.float32)})
    return out


def test_example_fit_matches_the_jax_example(tmp_path, setup):
    params = setup[0]
    jex = load_example("examples/diffusion/model_def.py", "jax_diff_example")
    tex = load_example("examples/diffusion_cuda/model_def.py",
                       "torch_diff_example")
    images = tex.synthetic_images(64, 16)
    train, val = noisy_batches(images, 1, FIT_STEPS), \
        noisy_batches(images, 2, 1)

    class JTrial(jex.DiffusionTrial):
        def init_params(self, rng):
            return jax.tree_util.tree_map(jnp.asarray, params)

        def loss(self, p, batch, rng):
            loss = jax_loss_from_noise(p, batch["images"], batch["t"],
                                       batch["eps"])
            return loss, {"loss": loss}

        def build_training_data(self):
            return train

        def build_validation_data(self):
            return val

        def evaluate(self, p, batch):
            return {"validation_loss": self.loss(p, batch, None)[0]}

    class TTrial(tex.DiffusionTrial):
        def init_params(self, rng):
            return tdiff.params_from_numpy(params, rng.device)

        def loss(self, p, batch, rng):
            return tdiff.loss_from_noise(p, batch["images"], batch["t"],
                                         batch["eps"], self.cfg)

        def build_training_data(self):
            return train

        def build_validation_data(self):
            return val

        def evaluate(self, p, batch):
            return {"validation_loss": self.loss(p, batch, None)[0]}

    jctx = jcore.init(max_length=FIT_STEPS,
                      checkpoint_dir=str(tmp_path / "jax"))
    JTrainer(JTrial(JTrialContext(hparams=HP, core_context=jctx)),
             core_context=jctx, devices=jax.devices()[:1]).fit(
        report_period=1)
    jctx.close()
    tctx = tcore.init(max_length=FIT_STEPS,
                      checkpoint_dir=str(tmp_path / "port"))
    TTrainer(TTrial(TTrialContext(hparams=HP, core_context=tctx)),
             core_context=tctx, device="cpu").fit(report_period=1)
    tctx.close()
    jrep = [r["metrics"] for r in jctx.train.local_training_metrics]
    trep = [r["metrics"] for r in tctx.train.local_training_metrics]
    assert len(jrep) == len(trep) == FIT_STEPS
    for key, rtol in (("loss", 1e-5), ("grad_norm", 5e-5)):
        np.testing.assert_allclose([r[key] for r in trep],
                                   [r[key] for r in jrep], rtol=rtol,
                                   err_msg=key)
    np.testing.assert_allclose(
        tctx.train.local_validation_metrics[-1]["metrics"]["validation_loss"],
        jctx.train.local_validation_metrics[-1]["metrics"]["validation_loss"],
        rtol=1e-5)


def test_a_jax_pretrain_pickle_loads_through_pretrained_path(tmp_path,
                                                             setup):
    params, images, t, _ = setup
    jex = load_example("examples/diffusion/model_def.py", "jax_diff_example")
    tex = load_example("examples/diffusion_cuda/model_def.py",
                       "torch_diff_example")
    path = str(tmp_path / "pre.pkl")
    jex.save_params(jax.tree_util.tree_map(jnp.asarray, params), path)
    trial = tex.DiffusionTrial(TTrialContext(hparams={
        **HP, "pretrained_path": path}))
    tp = trial.init_params(torch.Generator().manual_seed(0))
    want = np.asarray(japply(params, images, t, JCFG))
    got = tdiff.apply(tp, torch.from_numpy(images), torch.from_numpy(t),
                      TCFG)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # The port's file is the JAX layout too: the JAX example reads it.
    back = str(tmp_path / "back.pkl")
    tex.save_params(tp, back)
    assert_trees(jex.load_params(back), params, 0, "port -> JAX")

    missing = str(tmp_path / "nope.pkl")
    for ex, ctx in ((jex, JTrialContext), (tex, TTrialContext)):
        with pytest.raises(FileNotFoundError) as e:
            ex.DiffusionTrial(ctx(hparams={**HP, "pretrained_path": missing}))
        assert str(e.value) == (
            f"pretrained_path set but missing: {missing} — refusing to "
            "silently train from scratch")
        with pytest.raises(ValueError) as e:
            ex.load_params(str(tmp_path))
        assert str(e.value) == (
            f"pretrained_path must be a params pickle (pretrain.py --out), "
            f"not a checkpoint directory: {tmp_path}. To fine-tune from a "
            "platform checkpoint, resume the experiment instead, or export "
            "its params with save_params().")
