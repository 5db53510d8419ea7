"""`Trainer.fit`'s step on one process: the captured route, on the CPU.

On one card `fit` runs `make_captured_step` (one CUDA graph a batch shape,
replayed); on the CPU the same step object runs its plain version, the
step the graph holds (the optimizer's floats as a tensor), with the
graph's state contract: the state's tensors stay the ones of the first
call. Here:

  - Parity, through a planted divergence that rolls back
    (`health.on_nan: rollback`) and a resume: tiny fp32 GPT-2 and the
    stateful ResNet trial (CIFAR stem at 8x8, BatchNorm stats in
    `extra`), numpy-drawn, against the JAX Trainer on one CPU device.
    Every report window's loss and grad norm: atol 1e-4, rtol 1e-5 (the
    same arithmetic in another summation order, through the optimizer's
    updates; a window of the poisoned step is NaN on both sides). Every
    state tensor's `data_ptr` is the same before and after the rollback.
  - Capture safety: two consecutive fit steps of each trial `fit` runs in
    the port's examples and in chip_smoke.py (GPT-2 dense in bf16 and
    fp32 at every remat policy, MoE GPT-2, MNIST, the CIFAR ResNet-18
    trial, the DDPM UNet), each step under a `TorchDispatchMode` that
    records every host read of a tensor (`aten._local_scalar_dense`,
    `aten.equal`, `.tolist()`, `.cpu()`, `.numpy()`; left out:
    `F.one_hot`'s class-value check, which reads the host on the CPU
    only) and the state's tensor addresses before and after: a CUDA
    graph holds neither a host read nor a new address. The detector has
    teeth: a loss that calls `.item()` and one that swaps a parameter's
    storage are refused (and the step refuses the second on its next
    call).
  - The route `_build_steps` takes (`trainer.step_route`): captured on
    CUDA at world 1 and at world 2, eager with an optimizer without
    `hyper`, each with its reason.
"""

import concurrent.futures
import dataclasses
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from determined_tpu import core as jcore
from determined_tpu.models import gpt2 as jgpt2
from determined_tpu.models import resnet as jresnet
from determined_tpu.train import JaxTrial
from determined_tpu.train import Trainer as JTrainer
from determined_tpu.train.trial import TrialContext as JTrialContext
from determined_tpu_torch import core as tcore
from determined_tpu_torch.models import gpt2 as tgpt2
from determined_tpu_torch.models import resnet as tresnet
from determined_tpu_torch.train import TorchTrial
from determined_tpu_torch.train import Trainer as TTrainer
from determined_tpu_torch.train import optim
from determined_tpu_torch.train import step as step_mod
from determined_tpu_torch.train.trainer import step_route
from determined_tpu_torch.train.trial import TrialContext as TTrialContext
from test_torch_resnet import configs, numpy_state
from test_torch_trainer import DIMS, numpy_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 1e-4, 1e-5
N_BATCHES, POISON_AT = 12, 5   # batch 5 (step 5) diverges
FIRST, RESUMED = 8, 10         # fit to step 8, then resume to step 10


def poisoned(batches):
    """`batches` each with a `poison` flag a row (the loaders split every
    leaf over the batch), set on the POISON_AT-th."""
    return [dict(b, poison=np.full(len(next(iter(b.values()))),
                                   i + 1 == POISON_AT, np.float32))
            for i, b in enumerate(batches)]


def gpt2_batches(seed, n, b=4, s=17):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, DIMS["vocab_size"], size=(b, s))
             .astype(np.int32)} for _ in range(n)]


def resnet_batches(seed, n, b=8):
    rng = np.random.default_rng(seed)
    return [{"images": rng.normal(size=(b, 8, 8, 3)).astype(np.float32),
             "labels": rng.integers(0, 5, b).astype(np.int32)}
            for _ in range(n)]


HEALTH = {"on_nan": "rollback", "rollback_window": 1, "max_rollbacks": 1}


class JaxGPT2(JaxTrial):
    health = HEALTH
    compile = {"upload": False}  # no second compile to export the step

    def __init__(self, context):
        super().__init__(context)
        self.cfg = jgpt2.Config(**DIMS, dtype=jnp.float32)

    def init_params(self, rng):
        return jax.tree_util.tree_map(jnp.asarray, numpy_params())

    def loss(self, params, batch, rng):
        loss = jgpt2.loss_fn(params, {"tokens": batch["tokens"]}, self.cfg)
        # A NaN loss with NaN gradients: the next step diverges too.
        return loss * jnp.where(jnp.any(batch["poison"] > 0), jnp.nan, 1.0)

    def optimizer(self):
        sched = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 1, 100)
        return optax.chain(optax.clip_by_global_norm(1.0),
                           optax.adamw(sched, b2=0.95, weight_decay=0.1))

    def build_training_data(self):
        return poisoned(gpt2_batches(1, N_BATCHES))


class TorchGPT2(TorchTrial):
    health = HEALTH

    def __init__(self, context):
        super().__init__(context)
        self.cfg = tgpt2.Config(**DIMS, dtype=torch.float32)

    def init_params(self, rng):
        return tgpt2.params_from_numpy(numpy_params(), rng.device)

    def loss(self, params, batch, rng):
        loss = tgpt2.loss_fn(params, {"tokens": batch["tokens"]}, self.cfg)
        # No host read: the poisoned step is NaN on the device, its
        # gradients too.
        return loss * torch.where((batch["poison"] > 0).any(), float("nan"),
                                  1.0)

    def optimizer(self):
        sched = optim.warmup_cosine_decay_schedule(0.0, 1e-3, 1, 100)
        return optim.chain(optim.clip_by_global_norm(1.0),
                           optim.adamw(sched, b2=0.95, weight_decay=0.1))

    def build_training_data(self):
        return poisoned(gpt2_batches(1, N_BATCHES))


class JaxResNet(JaxTrial):
    stateful = True
    health = HEALTH
    compile = {"upload": False}

    def __init__(self, context):
        super().__init__(context)
        self.cfg = configs("basic")[0]

    def init_params(self, rng):
        return jax.tree_util.tree_map(jnp.asarray, numpy_state("basic")[0])

    def init_extra(self):
        return jax.tree_util.tree_map(jnp.asarray, numpy_state("basic")[1])

    def loss(self, params, extra, batch, rng):
        plain = {k: batch[k] for k in ("images", "labels")}
        loss, aux, new = jresnet.loss_fn(params, extra, plain, rng, self.cfg)
        # A NaN loss with NaN gradients: the next step diverges too.
        return (loss * jnp.where(jnp.any(batch["poison"] > 0), jnp.nan, 1.0),
                aux, new)

    def optimizer(self):
        return optax.sgd(0.1, momentum=0.9)

    def build_training_data(self):
        return poisoned(resnet_batches(3, N_BATCHES))


class TorchResNet(TorchTrial):
    stateful = True
    health = HEALTH

    def __init__(self, context):
        super().__init__(context)
        self.cfg = configs("basic")[1]

    def init_params(self, rng):
        return tresnet.params_from_numpy(numpy_state("basic")[0], rng.device)

    def init_extra(self):
        return tresnet.params_from_numpy(numpy_state("basic")[1])

    def loss(self, params, extra, batch, rng):
        plain = {k: batch[k] for k in ("images", "labels")}
        loss, aux, new = tresnet.loss_fn(params, extra, plain, rng, self.cfg)
        return (loss * torch.where((batch["poison"] > 0).any(),
                                   float("nan"), 1.0), aux, new)

    def supports_model_parallel(self):
        return False

    def optimizer(self):
        return optim.sgd(0.1, momentum=0.9)

    def build_training_data(self):
        return poisoned(resnet_batches(3, N_BATCHES))


def jax_run(trial_cls, tmp_path):
    """-> the JAX Trainer's reports of both fits."""
    reports = []
    for length, resume in ((FIRST, None), (RESUMED, f"trial0-step{FIRST}")):
        ctx = jcore.init(max_length=length, checkpoint_dir=str(tmp_path / "j"))
        JTrainer(trial_cls(JTrialContext(core_context=ctx)),
                 core_context=ctx, devices=jax.devices()[:1]).fit(
            report_period=2, checkpoint_period=4, resume_from=resume)
        ctx.close()
        reports += ctx.train.local_training_metrics
    return reports


def port_run(trial_cls, tmp_path):
    """-> (reports, the state's addresses before and after each restore,
    the final state)."""
    reports, around = [], []
    for length, resume in ((FIRST, None), (RESUMED, f"trial0-step{FIRST}")):
        ctx = tcore.init(max_length=length, checkpoint_dir=str(tmp_path / "t"))
        trainer = TTrainer(trial_cls(TTrialContext(core_context=ctx)),
                           core_context=ctx, device="cpu")
        chain = trainer._restore_chain

        def recorded(*a, _chain=chain, _t=trainer, **k):
            before = step_mod._state_ptrs(_t.state)
            out = _chain(*a, **k)
            around.append((k.get("into", False), before,
                           step_mod._state_ptrs(_t.state)))
            return out

        trainer._restore_chain = recorded
        state = trainer.fit(report_period=2, checkpoint_period=4,
                            resume_from=resume)
        ctx.close()
        assert isinstance(trainer._train_step, step_mod._CapturedStep)
        reports += ctx.train.local_training_metrics
    return reports, around, state


@pytest.mark.parametrize("trials", [(JaxGPT2, TorchGPT2),
                                    (JaxResNet, TorchResNet)],
                         ids=["gpt2", "resnet_stateful"])
def test_fit_matches_the_jax_trainer_through_rollback_and_resume(
        tmp_path, trials):
    # The JAX fits (mostly XLA compiles and orbax writes) run on a thread
    # beside the port's.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_fits = pool.submit(jax_run, trials[0], tmp_path)
        treps, around, state = port_run(trials[1], tmp_path)
        jreps = jax_fits.result()
    steps = [r["steps_completed"] for r in treps]
    # Step 5 diverged: the window of steps 5-6 is NaN, the state goes back
    # to step 4's checkpoint, one batch is skipped, steps 5-8 run again;
    # the resume from step 8's checkpoint trains steps 9 and 10.
    assert steps == [r["steps_completed"] for r in jreps] == \
        [2, 4, 6, 6, 8, 10]
    for t, j in zip(treps, jreps):
        for k in ("loss", "grad_norm", "all_finite"):
            # float(): a non-finite value may be reported as a string.
            np.testing.assert_allclose(float(t["metrics"][k]),
                                       float(j["metrics"][k]),
                                       atol=ATOL, rtol=RTOL,
                                       err_msg=f"{k} at {t['steps_completed']}")
    assert np.isnan(float(treps[2]["metrics"]["loss"])) and \
        treps[2]["metrics"]["divergence"] == 1.0
    assert treps[0]["metrics"]["step_captured"] == 0.0
    assert treps[0]["metrics"]["step_route"].startswith("plain: ")
    # The resume at fit start replaced the fresh state (no step had run);
    # the rollback wrote into the live state: every tensor where it was.
    rollbacks = [(b, a) for into, b, a in around if into]
    assert len(rollbacks) == 1 and len(around) == 2
    before, after = rollbacks[0]
    assert before == after and len(before) > 0
    assert state.step == RESUMED
    assert all(torch.isfinite(t).all() for t in state.leaves())


# ------------------------------------------------------- capture safety

HOST_READS = {"_local_scalar_dense", "equal"}


class Detector(TorchDispatchMode):
    """Records, per step, every host read and the state's addresses
    before and after the step."""

    def __init__(self):
        super().__init__()
        self.steps = []
        self.cpu_only = 0

    def record(self, what):
        if not self.cpu_only:
            self.steps[-1]["host_reads"].append(what)

    def one_hot(self, orig):
        """`F.one_hot`, whose class-value check reads the host on the CPU
        only (on CUDA the scatter's device assert stands for it)."""
        def wrapped(*a, **k):
            self.cpu_only += 1
            try:
                return orig(*a, **k)
            finally:
                self.cpu_only -= 1
        return wrapped

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if func.namespace == "aten" and name in HOST_READS:
            self.record(f"aten.{name}")
        return func(*args, **(kwargs or {}))

    def run(self, state, fn):
        """fn() as one step under the detector."""
        self.steps.append({"host_reads": [],
                           "before": step_mod._state_ptrs(state)})
        patches = []
        for meth in ("tolist", "cpu", "numpy"):
            orig = getattr(torch.Tensor, meth)

            def wrapped(t, *a, _orig=orig, _meth=meth, **k):
                self.record(f"Tensor.{_meth}")
                return _orig(t, *a, **k)
            patches.append(mock.patch.object(torch.Tensor, meth, wrapped))
        patches.append(mock.patch.object(
            F, "one_hot", self.one_hot(F.one_hot)))
        for p in patches:
            p.start()
        try:
            with self:
                return fn()
        finally:
            for p in patches:
                p.stop()
            self.steps[-1]["after"] = step_mod._state_ptrs(state)

    def refusals(self):
        """What a CUDA graph could not hold, over the recorded steps."""
        out = [f"step {i}: {r}" for i, s in enumerate(self.steps)
               for r in s["host_reads"]]
        first = self.steps[0]["before"] if self.steps else None
        for i, s in enumerate(self.steps):
            if s["before"] != first or s["after"] != first:
                out.append(f"step {i}: the state's tensors moved")
        return out


def detected_fit(trial, tmp_path, steps=2):
    """`steps` fit steps of `trial` on the CPU, each of the captured step's
    calls under a Detector -> (detector, error raised or None)."""
    det = Detector()
    plain = step_mod._CapturedStep._plain

    def watched(self, state, batch, rng):
        return det.run(state, lambda: plain(self, state, batch, rng))

    trainer = TTrainer(trial, core_context=trial.context.core,
                       device="cpu")
    err = None
    with mock.patch.object(step_mod._CapturedStep, "_plain", watched):
        try:
            trainer.fit(report_period=steps)
        except RuntimeError as e:
            err = e
    trial.context.core.close()
    assert isinstance(trainer._train_step, step_mod._CapturedStep)
    return det, err


def context(tmp_path, name, steps=2, **hparams):
    ctx = tcore.init(max_length=steps,
                     checkpoint_dir=str(tmp_path / name))
    return TTrialContext(hparams=hparams, core_context=ctx)


def example(rel, name):
    sys.path.insert(0, os.path.join(REPO, "examples", rel))
    try:
        import importlib

        module = importlib.import_module("model_def")
        importlib.reload(module)
        return getattr(module, name)
    finally:
        sys.path.pop(0)


def small_validation(trial, n=1):
    """The trial with its validation data cut to `n` batches (the op-end
    pass is not the step under test)."""
    data = trial.build_validation_data
    trial.build_validation_data = lambda: list(data())[:n]
    return trial


def assert_capturable(trial, tmp_path):
    det, err = detected_fit(small_validation(trial), tmp_path)
    assert err is None and len(det.steps) == 2
    assert det.refusals() == []


GPT2_HP = {"model_size": "tiny", "seq_len": 16, "global_batch_size": 2,
           "learning_rate": 1e-3, "warmup_steps": 1,
           "attention_impl": "flash"}


def test_gpt2_dense_steps_are_capturable_at_every_remat_policy(tmp_path):
    GPT2Trial = example("gpt2_cuda", "GPT2Trial")
    for dtype in (torch.bfloat16, torch.float32):
        for policy in (None, "nothing", "dots", "dots_saveable",
                       "everything"):
            name = f"gpt2_{str(dtype)[6:]}_{policy}"
            trial = GPT2Trial(context(tmp_path, name, **GPT2_HP))
            trial.cfg = dataclasses.replace(trial.cfg, dtype=dtype,
                                            remat_policy=policy)
            assert_capturable(trial, tmp_path)


def test_moe_gpt2_steps_are_capturable(tmp_path):
    GPT2Trial = example("gpt2_cuda", "GPT2Trial")
    trial = GPT2Trial(context(tmp_path, "moe", num_experts=4, moe_top_k=2,
                              **GPT2_HP))
    assert trial.cfg.num_experts == 4
    assert_capturable(trial, tmp_path)


def test_mnist_steps_are_capturable(tmp_path):
    MNistTrial = example("mnist_cuda", "MNistTrial")
    trial = MNistTrial(context(tmp_path, "mnist", global_batch_size=8,
                               hidden=16))
    assert_capturable(trial, tmp_path)


def test_cifar_resnet18_steps_are_capturable(tmp_path):
    sys.path.insert(0, REPO)
    import chip_smoke

    CifarTrial = chip_smoke.cifar_trial_class()
    trial = CifarTrial(context(tmp_path, "cifar", global_batch_size=2,
                               dtype="float32"))
    assert trial.stateful
    assert_capturable(trial, tmp_path)


def test_diffusion_unet_steps_are_capturable(tmp_path):
    DiffusionTrial = example("diffusion_cuda", "DiffusionTrial")
    trial = DiffusionTrial(context(tmp_path, "unet", model_size="tiny",
                                   global_batch_size=2))
    assert_capturable(trial, tmp_path)


def test_the_detector_refuses_a_host_read_and_a_moved_tensor(tmp_path):
    GPT2Trial = example("gpt2_cuda", "GPT2Trial")

    class HostRead(GPT2Trial):
        def loss(self, params, batch, rng):
            loss = super().loss(params, batch, rng)
            return loss * (1.0 if loss.item() > 0 else 1.0)

    det, err = detected_fit(small_validation(
        HostRead(context(tmp_path, "read", **GPT2_HP))), tmp_path)
    assert err is None
    assert det.refusals() == ["step 0: aten._local_scalar_dense",
                              "step 1: aten._local_scalar_dense"]

    class Moves(GPT2Trial):
        def loss(self, params, batch, rng):
            wte = params["wte"]
            wte.data = wte.data.clone()  # a new storage, same values
            return super().loss(params, batch, rng)

    det, err = detected_fit(small_validation(
        Moves(context(tmp_path, "moves", **GPT2_HP))), tmp_path)
    assert det.refusals() == ["step 0: the state's tensors moved"]
    # ... and the step itself refuses its next call on the moved state.
    assert err is not None and "not the ones the step captured" in str(err)


@pytest.mark.parametrize("case", ["cuda_world1", "cuda_world2",
                                  "no_hyper"])
def test_the_route_is_decided_with_its_reason(case):
    tx = optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(1e-3))
    cuda = torch.device("cuda", 0)
    if case == "cuda_world1":
        assert step_route(cuda, 1, tx) == (
            "captured", "one CUDA graph a batch shape, replayed")
        assert step_route("cpu", 1, tx)[0] == "plain"
    elif case == "cuda_world2":
        assert step_route(cuda, 2, tx) == (
            "captured", "one CUDA graph a batch shape on each of the 2 "
            "ranks, replayed in lockstep")
        assert step_route("cpu", 2, tx)[0] == "plain"
    else:
        bare = optim.GradientTransformation(tx.init, tx.update)
        assert step_route(cuda, 1, bare) == (
            "eager", "the optimizer has no `hyper` (train/optim.py) to feed "
            "a replay its host floats")
        with pytest.raises(ValueError, match="needs a transformation with"):
            step_mod.make_captured_step(lambda p, b, r: 0.0, bare)
