"""The port's abstract engine (determined_tpu_torch/analysis/abstract.py)
against the JAX package's, on the CPU.

The same trial goes through both engines at meshes 1, 2 (`fsdp`), 4
(`data` 2 x `fsdp` 2) and 2 (`tensor`): GPT-2 at TINY width from
examples/gpt2 and examples/gpt2_cuda, MNIST from examples/mnist and
examples/mnist_cuda (the JAX trial given the same logical axes as the
port's, which its example leaves out), and a TINY ResNet with its
BatchNorm extra, defined here over both packages' models.

  - params, grads, batch and the params total are equal, exactly.
  - The optimizer state is equal but for the JAX package's int32 step
    counts (optax's `count` leaves of Adam and of the schedule): the port
    keeps them as host ints (train/optim.py), which hold no device
    memory. `total_bytes` differs by exactly those bytes.
  - The activation upper bound is a different count of the same thing:
    JAX sums the outputs of the loss jaxpr's top-level equations (a
    `remat` or `scan` counts by its outputs alone), the port every aten
    op's fresh output. The ratio port / JAX must lie in ACT_RATIO_BAND
    (each is printed), and the port's must be at least what autograd
    saves for the backward, measured on the CPU.
  - With the kernel route, no [S, S] tensor is counted.
  - At gloo world 2 with `fsdp` 2, the estimate's per-device params and
    optimizer bytes equal the local shards of a real sharded TrainState.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from determined_tpu.analysis.abstract import analyze_trial as jax_analyze
from determined_tpu.models import resnet as jresnet
from determined_tpu.train import JaxTrial
from determined_tpu.train.trial import TrialContext as JContext
from determined_tpu_torch.analysis import abstract
from determined_tpu_torch.models import resnet
from determined_tpu_torch.train import TorchTrial, optim
from determined_tpu_torch.train.trial import TrialContext

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# port / JAX activation bytes. Measured at these sizes: GPT-2 4.674 (JAX
# sees the remat'd blocks and the layer scan by their outputs alone),
# MNIST 0.875, ResNet 0.742 (JAX counts its dtype converts and broadcasts
# as equations where torch folds them into the op).
ACT_RATIO_BAND = (0.5, 6.0)
MESHES = [({}, 1), ({"fsdp": 2}, 2), ({"data": 2, "fsdp": 2}, 4),
          ({"tensor": 2}, 2)]
GPT2_HP = {"model_size": "tiny", "seq_len": 128, "global_batch_size": 8}
MNIST_HP = {"global_batch_size": 16, "hidden": 32}
RESNET_CFG = dict(stage_sizes=(1, 1), num_filters=8, n_classes=10)
RESNET_BATCH, RESNET_HW = 8, 16


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _resnet_batches(seed=0):
    rng = np.random.default_rng(seed)
    while True:
        yield {"images": rng.normal(size=(RESNET_BATCH, RESNET_HW, RESNET_HW,
                                          3)).astype(np.float32),
               "labels": rng.integers(0, 10, RESNET_BATCH).astype(np.int32)}


class JaxResNetTrial(JaxTrial):
    stateful = True
    cfg = jresnet.Config(**RESNET_CFG)

    def init_params(self, rng):
        return jresnet.init(rng, self.cfg)[0]

    def init_extra(self):
        # Shapes are what the engine reads (no eager init: it is slow).
        return jax.eval_shape(
            lambda: jresnet.init(jax.random.PRNGKey(0), self.cfg)[1])

    def param_logical_axes(self):
        return jresnet.param_logical_axes(self.cfg)

    def loss(self, params, extra, batch, rng):
        return jresnet.loss_fn(params, extra, batch, rng, self.cfg)

    def optimizer(self):
        import optax

        return optax.sgd(0.1, momentum=0.9)

    def build_training_data(self):
        return _resnet_batches()


class ResNetTrial(TorchTrial):
    stateful = True
    cfg = resnet.Config(**RESNET_CFG)

    def init_params(self, rng):
        return resnet.init(rng, self.cfg)[0]

    def init_extra(self):
        return resnet.init_stats(self.cfg)

    def param_logical_axes(self):
        return resnet.param_logical_axes(self.cfg)

    def loss(self, params, extra, batch, rng):
        return resnet.loss_fn(params, extra, batch, rng, self.cfg)

    def optimizer(self):
        return optim.sgd(0.1, momentum=0.9)

    def build_training_data(self):
        return _resnet_batches()


@pytest.fixture(scope="module")
def trials():
    """model -> (make JAX trial(hparams, n), make port trial(hparams, n))."""
    jgpt, tgpt = (_load("examples/gpt2/model_def.py", "_jgpt2"),
                  _load("examples/gpt2_cuda/model_def.py", "_tgpt2"))
    jmn, tmn = (_load("examples/mnist/model_def.py", "_jmnist"),
                _load("examples/mnist_cuda/model_def.py", "_tmnist"))
    from determined_tpu.models import mnist as jmnist_model

    class JaxMNIST(jmn.MNistTrial):
        def param_logical_axes(self):
            return jmnist_model.param_logical_axes(self.cfg)

    def pair(jcls, tcls, base):
        return (lambda hp, n: jcls(JContext(hparams={**base, **hp},
                                            n_devices=n)),
                lambda hp, n: tcls(TrialContext(hparams={**base, **hp},
                                                n_devices=n)))

    return {"gpt2": pair(jgpt.GPT2Trial, tgpt.GPT2Trial, GPT2_HP),
            "mnist": pair(JaxMNIST, tmn.MNistTrial, MNIST_HP),
            "resnet": pair(JaxResNetTrial, ResNetTrial, {})}


def _count_bytes(jtrial):
    """The bytes of the JAX optimizer state's scalar int32 step counts."""
    params = jax.eval_shape(jtrial.init_params, jax.random.PRNGKey(0))
    opt = jax.eval_shape(jtrial.optimizer().init, params)
    return sum(leaf.dtype.itemsize for leaf in jax.tree_util.tree_leaves(opt)
               if leaf.shape == () and jnp.issubdtype(leaf.dtype,
                                                      jnp.integer))


CASES = [(m, mesh, n) for m in ("gpt2", "mnist", "resnet")
         for mesh, n in MESHES]


@pytest.mark.parametrize("model,mesh,n", CASES,
                         ids=[f"{m}-{n}-{'x'.join(mesh) or 'data'}"
                              for m, mesh, n in CASES])
def test_bytes_match_jax(trials, model, mesh, n):
    make_jax, make_port = trials[model]
    jtrial = make_jax({"mesh": mesh}, n)
    jd, jhbm, _ = jax_analyze(jtrial, n)
    d, hbm, notes = abstract.analyze_trial(make_port({"mesh": mesh}, n), n)
    assert [x.code for x in d] == [x.code for x in jd] == []
    assert notes == []
    for key in ("params_bytes", "grads_bytes", "batch_bytes",
                "params_total_bytes", "donation_extra_bytes", "mesh",
                "n_devices", "donated"):
        assert hbm[key] == jhbm[key], key
    counts = _count_bytes(jtrial)
    # JAX keys an optimizer leaf's split by its (shape, dtype), the first
    # param leaf of that shape deciding (its abstract.py:163-168); the port
    # takes the split of the leaf the moment mirrors. They part where two
    # param leaves of one shape split differently: MNIST over tensor 2,
    # where fc1's bias [hidden] splits over "mlp" and conv's bias of the
    # same shape does not. JAX counts fc1's bias momentum whole; it is
    # half (train/state.py keeps it as a shard of its leaf).
    mirror = MNIST_HP["hidden"] * 4 // 2 \
        if model == "mnist" and mesh == {"tensor": 2} else 0
    assert hbm["opt_state_bytes"] == \
        jhbm["opt_state_bytes"] - counts - mirror
    assert hbm["opt_state_total_bytes"] == \
        jhbm["opt_state_total_bytes"] - counts
    assert hbm["total_bytes"] == jhbm["total_bytes"] - counts - mirror
    ratio = hbm["activations_upper_bound_bytes"] / \
        jhbm["activations_upper_bound_bytes"]
    print(f"{model} mesh {mesh or {'data': n}}: activations port "
          f"{hbm['activations_upper_bound_bytes']} / JAX "
          f"{jhbm['activations_upper_bound_bytes']} = {ratio:.3f}")
    assert ACT_RATIO_BAND[0] <= ratio <= ACT_RATIO_BAND[1]


def _saved_bytes(trial, batch):
    """Bytes autograd saves for the backward of one CPU loss: each saved
    tensor's storage once, the params' and the batch's own left out."""
    from determined_tpu_torch.train.state import param_leaves

    params = trial.init_params(torch.Generator().manual_seed(0))
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    inputs = {t.untyped_storage().data_ptr() for t in leaves + list(
        batch.values())}
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in inputs:
            seen[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        if trial.stateful:
            out = trial.loss(params, trial.init_extra(), batch, None)
        else:
            out = trial.loss(params, batch, None)
    assert (out[0] if isinstance(out, tuple) else out).requires_grad
    return sum(seen.values())


class KernelShapeGPT2(TorchTrial):
    """GPT-2 at a head dim the kernels take (D 64; TINY's is 16, which the
    card too runs on the plain attention)."""

    def __init__(self, context):
        super().__init__(context)
        from determined_tpu_torch.models import gpt2

        self.gpt2 = gpt2
        self.cfg = gpt2.Config(
            vocab_size=320, n_positions=256, d_model=128, n_layer=1,
            n_head=2, attention_impl=context.hparams["attention_impl"])

    def init_params(self, rng):
        return self.gpt2.init(rng, self.cfg)

    def loss(self, params, batch, rng):
        return self.gpt2.loss_fn(params, batch, self.cfg)

    def build_training_data(self):
        rng = np.random.default_rng(0)
        while True:
            yield {"tokens": rng.integers(0, 320, (4, 257)).astype(np.int32)}


# One rank of a world of 2 with fsdp 2: the example's TINY GPT-2 state laid
# out for real (a gloo group over a FileStore), and the bytes of this
# rank's shards of the params and of the moments that mirror them.
_LAYOUT_WORKER = r"""
import importlib.util, json, os, sys
import torch
import torch.distributed as dist
from determined_tpu_torch.parallel import sharding
from determined_tpu_torch.parallel.mesh import MeshConfig, create_mesh
from determined_tpu_torch.train.state import _mirrors, create_train_state
from determined_tpu_torch.train.trial import TrialContext

rank, out, hp = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
dist.init_process_group("gloo", init_method="file://" + os.path.join(
    out, "store"), rank=rank, world_size=2)
spec = importlib.util.spec_from_file_location("m", sys.argv[4])
m = importlib.util.module_from_spec(spec)
spec.loader.exec_module(m)
trial = m.GPT2Trial(TrialContext(hparams=hp, n_devices=2))
mesh = create_mesh(MeshConfig(fsdp=2), device_type="cpu")
state = create_train_state(
    trial.init_params, trial.optimizer(),
    torch.Generator().manual_seed(0), device="cpu", mesh=mesh,
    param_logical_axes=trial.param_logical_axes(),
    rules=trial.sharding_rules())
local = [sharding.local_value(p) for p in state.leaves()]
nbytes = lambda t: t.numel() * t.element_size()
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump({"params": sum(nbytes(t) for t in local),
               "moments": sum(nbytes(t) for t, i in
                              _mirrors(state.opt_state, local)),
               "sharded": sum(1 for p in state.leaves()
                              if sharding.shard_mesh_dims(p))}, f)
dist.destroy_process_group()
"""


