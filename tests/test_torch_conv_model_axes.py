"""MNIST, ResNet and the diffusion UNet over the `tensor` and `context`
mesh axes: the port against the JAX package, on the CPU.

One world of 4 gloo processes (a worker per rank over a FileStore in the
test's directory; the worker imports only the port) runs every case,
while the test computes the JAX side:

  - the models, from numpy-drawn params in the JAX layout: MNIST (hidden
    32), the `basic` CIFAR ResNet of tests/test_torch_resnet.py (stage
    sizes (1, 1), 8 filters, 8x8 images; 6 classes, so the head splits
    evenly) and `diffusion.Config.tiny()`, each laid out by
    `train/state.create_train_state` over `data 2 x tensor 2` and
    `context 2 x tensor 2`. The loss and every gradient (gathered into
    the one-process layout), and ResNet's new batch statistics, are held
    to the JAX `loss_fn` and `jax.grad` on 4 of the 8 virtual CPU devices
    under the same mesh, the params placed by their logical axes.
  - the work each rank does: the weights that reach `F.conv2d` and the
    operands of every product in a forward over `tensor 2`, against the
    same forward in one process. A split conv or product does half the
    work; only the JAX model's replicated ones (MNIST's and ResNet's
    convs, the UNet's `conv_out` and time MLP) do it whole.
  - the UNet's `qkv` kernel in the state's tensor layout (`Fused`): each
    rank's slice holds its columns of q, k and v, and the layout
    round-trips bit for bit; every rank's leaf is the piece
    `sharding.tensor_piece` cuts in one process.
  - what is refused before any state: a split the `tensor` size does not
    divide (ResNet's 5 classes at tensor 2), and `expert: 2` (by the
    Trainer, and by the models on a mesh with that axis).
  - the preflight: the diffusion example at `data 2 x tensor 2` passes
    the config rules, and the estimate's per-device params and optimizer
    bytes are a rank's real shards.
  - the Trainer: MNIST's example trial (hidden 32, B 16) and
    chip_smoke.py's CIFAR ResNet-18 trial (bf16, B 8) fit 2 steps each at
    `data 1 x context 2 x tensor 2`, held to the same trials' fits in one
    process (losses rtol 1e-5, grad norms 5e-5).

The fit of the UNet against the JAX Trainer, and its checkpoint, are
in test_torch_conv_model_axes_fit.py (a world of its own, so that
`--dist loadfile` runs the two files on two workers).

Tolerances, fp32 with the sums in other orders (across ranks, over
channel slices, in XLA): gradients and statistics within 1e-5 of each
leaf's largest element; losses rtol 1e-5.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from determined_tpu.models import diffusion as jdiff
from determined_tpu.models import mnist as jmnist
from determined_tpu.models import resnet as jresnet
from determined_tpu.parallel.mesh import MeshConfig as JMeshConfig
from determined_tpu.parallel.mesh import create_mesh as jcreate_mesh
from determined_tpu.train.state import aligned_param_specs
from determined_tpu_torch.analysis import _preflight
from determined_tpu_torch.models import diffusion as tdiff
from determined_tpu_torch.models import mnist as tmnist
from determined_tpu_torch.models import resnet as tresnet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
MESHES = {"data2_tensor2": {"data": 2, "tensor": 2},
          "context2_tensor2": {"data": 1, "context": 2, "tensor": 2}}
MODELS = ("mnist", "resnet", "diffusion")
BATCH = 8
MNIST_HIDDEN = 32
RESNET_DIMS = dict(stage_sizes=(1, 1), num_filters=8, n_classes=6,
                   bottleneck=False, cifar_stem=True)
RESNET_SIZE = 8
# The diffusion example's hparams at the tiny size.
DIFF_HP = {"model_size": "tiny", "global_batch_size": 4,
           "learning_rate": 1e-3, "grad_clip": 1.0, "weight_decay": 0.01}
# MNIST's example trial and chip_smoke.py's CIFAR trial fit OTHER_STEPS
# steps over OTHER_MESH, and in one process.
OTHER_MESH = {"data": 1, "context": 2, "tensor": 2}
MNIST_HP = {"learning_rate": 0.05, "hidden": 32, "global_batch_size": 16}
CIFAR_HP = {"global_batch_size": 8}
OTHER_STEPS = 2
TIMEOUT_S = 150

WORKER = r'''
import importlib.util, json, os, sys
import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode
from determined_tpu_torch import core
from determined_tpu_torch.core._distributed import DistributedContext
from determined_tpu_torch.models import diffusion, mnist, resnet
from determined_tpu_torch.models.gpt2 import map_params
from determined_tpu_torch.parallel import sharding
from determined_tpu_torch.parallel.mesh import (
    MeshConfig, axis_group, batch_shard, create_mesh)
from determined_tpu_torch.train import Trainer, optim
from determined_tpu_torch.train import state as state_mod
from determined_tpu_torch.train.step import global_mean
from determined_tpu_torch.train.trial import TrialContext

rank, world, out, repo = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
(MESHES, RESNET_DIMS, DIFF_HP, OTHER_MESH, MNIST_HP,
 CIFAR_HP) = (json.loads(a) for a in sys.argv[5:11])
OTHER_STEPS = int(sys.argv[11])
RESNET_DIMS["stage_sizes"] = tuple(RESNET_DIMS["stage_sizes"])
CFG = {"mnist": mnist.Config(hidden=32),
       "resnet": resnet.Config(**RESNET_DIMS, dtype=torch.float32),
       "diffusion": diffusion.Config.tiny()}
MODEL = {"mnist": mnist, "resnet": resnet, "diffusion": diffusion}


def load(name):
    with np.load(os.path.join(out, name + ".npz")) as f:
        return {k: f[k] for k in f.files}


def unflatten(flat):
    tree = {}
    for path, val in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def flatten(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree) \
        if isinstance(tree, list) else None
    if items is None:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}{k}/"))
    return out


def rebuild(params, leaves):
    it = iter(leaves)
    return map_params(lambda _: next(it), params)


def example(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(repo, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Work(TorchFunctionMode):
    """The weights reaching F.conv2d and the operands of each product."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is F.conv2d:
            self.ops.append(["conv", list(args[1].shape)])
        elif func in (torch.matmul, torch.Tensor.matmul):
            self.ops.append(["matmul", list(args[0].shape),
                             list(args[1].shape)])
        return func(*args, **(kwargs or {}))


def loss_of(model, params, batch, extra):
    cfg = CFG[model]
    if model == "mnist":
        return mnist.loss_fn(params, batch, cfg)[0], None
    if model == "resnet":
        loss, _, stats = resnet.loss_fn(params, extra, batch, None, cfg)
        return loss, stats
    return diffusion.loss_from_noise(params, batch["images"], batch["t"],
                                     batch["eps"], cfg)[0], None


dist_ctx = DistributedContext.from_allocation(
    "file://" + os.path.join(out, "store"), world, rank, backend="gloo")
report = {"cases": {}}
BATCHES = {m: {k: torch.from_numpy(v) for k, v in load(m + "_batch").items()}
           for m in CFG}
ddiff = example("examples/diffusion_cuda/model_def.py", "diff_example")
DIFF_TRIAL = ddiff.DiffusionTrial(TrialContext(hparams=DIFF_HP))

# The models over each mesh.
for mesh_name, sizes in MESHES.items():
    mc = MeshConfig(**sizes)
    mesh = create_mesh(mc, "cpu")
    i, n = batch_shard(mc, rank, world)
    for model in CFG:
        mod, cfg = MODEL[model], CFG[model]
        full = mod.params_from_numpy(unflatten(load(model)))
        tx = DIFF_TRIAL.optimizer() if model == "diffusion" else \
            optim.adamw(1e-3)
        state = state_mod.create_train_state(
            lambda g: full, tx, torch.Generator(), mesh=mesh,
            param_logical_axes=mod.param_logical_axes(cfg))
        rows = BATCHES[model]["images"].shape[0] // n
        batch = {k: v[i * rows:(i + 1) * rows]
                 for k, v in BATCHES[model].items()}
        extra = resnet.params_from_numpy(unflatten(load("resnet_stats"))) \
            if model == "resnet" else None
        loss, stats = loss_of(model, state.params, batch, extra)
        grads = torch.autograd.grad(loss, state.leaves())
        whole = state_mod.full_leaves(state, list(grads))
        (loss,) = global_mean([loss])
        np.savez(os.path.join(out, f"{model}.{mesh_name}.rank{rank}.npz"),
                 loss=loss.detach().numpy(),
                 **flatten(mod.params_to_numpy(rebuild(full, whole))))
        if stats is not None:
            np.savez(os.path.join(out, f"stats.{mesh_name}.rank{rank}.npz"),
                     **flatten(resnet.params_to_numpy(stats)))
        case = {"round_trip": all(torch.equal(a, b) for a, b in zip(
            state_mod.full_leaves(state), state_mod.param_leaves(full)))}
        tensor = axis_group(mesh, "tensor")

        def pieces_match(whole, axes, laid):
            if isinstance(whole, dict):
                return all(pieces_match(whole[k], axes[k], laid[k])
                           for k in whole)
            return torch.equal(sharding.local_value(laid),
                               sharding.tensor_piece(whole, axes, tensor.index,
                                                     tensor.size))

        case["pieces"] = pieces_match(full, mod.param_logical_axes(cfg),
                                      state.params)
        with torch.no_grad(), Work() as work:
            loss_of(model, state.params, batch, extra)
        case["work"] = work.ops
        if model == "diffusion":
            attn = state.params["mid"]["attn"]["qkv"]
            want = full["mid"]["attn"]["qkv"]
            c = want["kernel"].shape[0]
            cols = c // tensor.size
            idx = torch.cat([torch.arange(p * c + tensor.index * cols,
                                          p * c + (tensor.index + 1) * cols)
                             for p in range(3)])
            case["qkv_columns"] = all(
                torch.equal(sharding.local_value(attn[k]),
                            want[k].index_select(-1, idx))
                for k in ("kernel", "bias"))
            case["local_bytes"] = {
                "params": sum(sharding.local_value(p).nbytes
                              for p in state.leaves()),
                "opt_state": sum(t.nbytes for t, _ in state_mod._mirrors(
                    state.opt_state, [sharding.local_value(p)
                                      for p in state.leaves()]))}
        report["cases"][f"{model}.{mesh_name}"] = case
        del state, grads

# What is refused before any state: an uneven split, and expert 2.
mesh = create_mesh(MeshConfig(data=2, tensor=2), "cpu")
odd = resnet.Config(**{**RESNET_DIMS, "n_classes": 5})
try:
    state_mod.create_train_state(
        lambda g: resnet.init(g, odd)[0], optim.sgd(0.1), torch.Generator(),
        mesh=mesh, param_logical_axes=resnet.param_logical_axes(odd))
    report["uneven"] = None
except ValueError as e:
    report["uneven"] = str(e)
mesh = create_mesh(MeshConfig(data=2, expert=2), "cpu")
state = state_mod.create_train_state(
    lambda g: mnist.init(g, CFG["mnist"]), optim.sgd(0.1),
    torch.Generator(), mesh=mesh,
    param_logical_axes=mnist.param_logical_axes(CFG["mnist"]))
try:
    mnist.loss_fn(state.params, BATCHES["mnist"], CFG["mnist"])
    report["expert_model"] = None
except ValueError as e:
    report["expert_model"] = str(e)
try:
    DIFF_TRIAL.context.hparams["mesh"] = {"data": 2, "expert": 2}
    Trainer(DIFF_TRIAL, device="cpu")
    report["expert_trainer"] = None
except ValueError as e:
    report["expert_trainer"] = str(e)
del state

# MNIST's example trial and chip_smoke.py's CIFAR trial through fit.
sys.path.insert(0, repo)
import chip_smoke
mnist_ex = example("examples/mnist_cuda/model_def.py", "mnist_example")
contexts = []
for name, Trial, hp in (("mnist", mnist_ex.MNistTrial, MNIST_HP),
                        ("cifar", chip_smoke.cifar_trial_class(), CIFAR_HP)):
    ctx = core.init(max_length=OTHER_STEPS, distributed=dist_ctx,
                    checkpoint_dir=os.path.join(out, f"ckpt_{name}"))
    trainer = Trainer(Trial(TrialContext(
        hparams={**hp, "mesh": OTHER_MESH}, core_context=ctx,
        global_batch_size=hp["global_batch_size"])), core_context=ctx,
        device="cpu")
    state = trainer.fit(report_period=1)
    report[f"fit_{name}"] = {
        "metrics": [r["metrics"] for r in ctx.train.local_training_metrics],
        "step": state.step,
        "mesh": dict(zip(trainer.mesh.mesh_dim_names,
                         trainer.mesh.mesh.shape))}
    ctx.checkpoint.wait()
    contexts.append(ctx)
with open(os.path.join(out, f"report{rank}.json"), "w") as f:
    json.dump(report, f)
for ctx in contexts:
    ctx.close()
'''


def flatten(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


JCFG = {"mnist": jmnist.Config(hidden=MNIST_HIDDEN),
        "resnet": jresnet.Config(**RESNET_DIMS, dtype=jnp.float32),
        "diffusion": jdiff.Config.tiny()}
TCFG = {"mnist": tmnist.Config(hidden=MNIST_HIDDEN),
        "resnet": tresnet.Config(**RESNET_DIMS, dtype=torch.float32),
        "diffusion": tdiff.Config.tiny()}
JMODEL = {"mnist": jmnist, "resnet": jresnet, "diffusion": jdiff}
TMODEL = {"mnist": tmnist, "resnet": tresnet, "diffusion": tdiff}


def jax_init(model):
    """init's shapes (params, and ResNet's stats)."""
    out = jax.eval_shape(lambda r: JMODEL[model].init(r, JCFG[model]),
                         jax.random.PRNGKey(0))
    return out if model == "resnet" else (out, None)


def numpy_tree(shapes, rng):
    """Kernels at a 1/sqrt(fan-in) scale, scales and variances 1 + noise,
    the rest small noise (nothing zero: every gradient is nonzero)."""
    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "scale" in name or "var" in name:
            return (1 + 0.1 * np.abs(rng.normal(size=s.shape))).astype(
                np.float32)
        fan = np.prod(s.shape[:-1]) if len(s.shape) > 1 else 10
        return (rng.normal(size=s.shape) / np.sqrt(fan)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def batch_for(model, rng, n=BATCH):
    if model == "mnist":
        return {"images": rng.normal(size=(n, 28, 28, 1)).astype(np.float32),
                "labels": rng.integers(0, 10, n).astype(np.int32)}
    if model == "resnet":
        s = RESNET_SIZE
        return {"images": rng.normal(size=(n, s, s, 3)).astype(np.float32),
                "labels": rng.integers(0, RESNET_DIMS["n_classes"],
                                       n).astype(np.int32)}
    size = JCFG["diffusion"].image_size
    return {"images": rng.uniform(-1, 1, (n, size, size, 3)).astype(
                np.float32),
            "t": rng.integers(0, JCFG["diffusion"].timesteps, n).astype(
                np.int32),
            "eps": rng.normal(size=(n, size, size, 3)).astype(np.float32)}


def jax_diffusion_loss(params, x0, t, eps):
    """The JAX loss_fn's body at given t and eps."""
    cfg = JCFG["diffusion"]
    ab = jdiff.alpha_bars(cfg)[t][:, None, None, None]
    xt = jnp.sqrt(ab) * x0 + jnp.sqrt(1.0 - ab) * eps
    return jnp.mean((jdiff.apply(params, xt, t, cfg) - eps) ** 2)


def jax_loss(model, params, stats, batch):
    """-> (loss, new stats or None)."""
    cfg = JCFG[model]
    if model == "mnist":
        return jmnist.loss_fn(params, batch, cfg)[0], None
    if model == "resnet":
        loss, _, new = jresnet.loss_fn(params, stats, batch, None, cfg)
        return loss, new
    return jax_diffusion_loss(params, batch["images"], batch["t"],
                              batch["eps"]), None


def model_inputs(seed=0):
    """{model: (params, stats or None, batch)} in the JAX layout."""
    rng = np.random.default_rng(seed)
    out = {}
    for model in MODELS:
        shapes, stat_shapes = jax_init(model)
        params = numpy_tree(shapes, rng)
        stats = numpy_tree(stat_shapes, rng) if stat_shapes else None
        out[model] = (params, stats, batch_for(model, rng))
    return out


@pytest.fixture(scope="module")
def inputs():
    return model_inputs()


@pytest.fixture(scope="module")
def world(tmp_path_factory, inputs, devices):
    """Every case in one world of 4, and the JAX side computed while it
    runs -> (the ranks' reports, the run dir, the JAX results)."""
    out = tmp_path_factory.mktemp("conv_world")
    for model, (params, stats, batch) in inputs.items():
        np.savez(out / f"{model}.npz", **flatten(params))
        np.savez(out / f"{model}_batch.npz", **batch)
        if stats is not None:
            np.savez(out / f"{model}_stats.npz", **flatten(stats))
    script = out / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    args = [json.dumps(a) for a in (MESHES, RESNET_DIMS, DIFF_HP, OTHER_MESH,
                                    MNIST_HP, CIFAR_HP)] + [str(OTHER_STEPS)]
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(WORLD), str(out), REPO,
         *args], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    try:
        ref = jax_side(inputs, devices)
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    reports = [json.loads((out / f"report{r}.json").read_text())
               for r in range(WORLD)]
    return reports, out, ref


def jax_side(inputs, devices):
    """JAX's loss, gradients (and ResNet's new stats) for each model on
    each mesh."""
    ref = {}
    for mesh_name, sizes in MESHES.items():
        mesh = jcreate_mesh(JMeshConfig(**sizes).resolve(WORLD),
                            devices[:WORLD])
        rows = NamedSharding(mesh, JP(("data", "fsdp")))
        for model, (params, stats, batch) in inputs.items():
            specs = aligned_param_specs(
                params, JMODEL[model].param_logical_axes(JCFG[model]))
            placed = jax.tree_util.tree_map(
                lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                params, specs)
            jbatch = {k: jax.device_put(v, rows) for k, v in batch.items()}

            def fn(p, b, model=model, stats=stats):
                return jax.value_and_grad(
                    lambda q: jax_loss(model, q, stats, b), has_aux=True)(p)

            with jax.sharding.set_mesh(mesh):
                (loss, new), grads = jax.jit(fn)(placed, jbatch)
            ref[(model, mesh_name)] = (float(loss), flatten(grads),
                                       None if new is None else flatten(new))
    return ref


def assert_leaves(got, want, rel, what):
    assert set(got) == set(want), what
    for k, w in want.items():
        err = np.abs(np.asarray(got[k]) - w).max()
        assert err <= rel * np.abs(w).max(), (what, k, err,
                                              np.abs(w).max())


CASES = [(m, mesh) for m in MODELS for mesh in MESHES]


@pytest.mark.parametrize("model,mesh", CASES,
                         ids=[f"{m}-{mesh}" for m, mesh in CASES])
def test_loss_and_every_gradient_match_jax(world, model, mesh):
    reports, out, ref = world
    loss, grads, stats = ref[(model, mesh)]
    for r in range(WORLD):
        got = dict(np.load(out / f"{model}.{mesh}.rank{r}.npz"))
        np.testing.assert_allclose(got.pop("loss"), loss, rtol=1e-5,
                                   err_msg=f"{model} {mesh} loss, rank {r}")
        assert_leaves(got, grads, 1e-5, f"{model} {mesh} grads, rank {r}")
        if stats is not None:
            assert_leaves(dict(np.load(out / f"stats.{mesh}.rank{r}.npz")),
                          stats, 1e-5, f"{mesh} batch stats, rank {r}")
        assert reports[r]["cases"][f"{model}.{mesh}"]["round_trip"]


def work_of(op):
    """The multiply-adds of one recorded op (a conv's per output pixel)."""
    if op[0] == "conv":
        return int(np.prod(op[1]))
    a, b = op[1], op[2]
    return int(np.prod(a[:-1])) * int(b[-1]) * int(a[-1])


def one_process_work(model, inputs):
    """The ops of the same forward in one process, recorded by the
    worker's mode (its source, run here)."""
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode

    params, stats, batch = inputs[model]
    ops = []

    class Work(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is F.conv2d:
                ops.append(["conv", list(args[1].shape)])
            elif func in (torch.matmul, torch.Tensor.matmul):
                ops.append(["matmul", list(args[0].shape),
                            list(args[1].shape)])
            return func(*args, **(kwargs or {}))

    mod, cfg = TMODEL[model], TCFG[model]
    tp = mod.params_from_numpy(params)
    rows = BATCH // 2  # a rank's rows at data 2
    tb = {k: torch.from_numpy(v[:rows]) for k, v in batch.items()}
    with torch.no_grad(), Work():
        if model == "mnist":
            mod.loss_fn(tp, tb, cfg)
        elif model == "resnet":
            mod.loss_fn(tp, mod.params_from_numpy(stats), tb, None, cfg)
        else:
            mod.loss_from_noise(tp, tb["images"], tb["t"], tb["eps"], cfg)
    return ops


@pytest.mark.parametrize("model", MODELS)
def test_each_tensor_rank_does_its_share(world, inputs, model):
    reports = world[0]
    whole = one_process_work(model, inputs)
    # The JAX model's replicated ops: MNIST's and ResNet's convs; the
    # UNet's conv_out (its last conv) and its time MLP (its first two
    # products).
    convs = [i for i, op in enumerate(whole) if op[0] == "conv"]
    products = [i for i, op in enumerate(whole) if op[0] == "matmul"]
    replicated = {"mnist": set(convs), "resnet": set(convs),
                  "diffusion": {convs[-1], *products[:2]}}[model]
    for r in range(WORLD):
        split = reports[r]["cases"][f"{model}.data2_tensor2"]["work"]
        assert [op[0] for op in split] == [op[0] for op in whole], r
        for i, (a, b) in enumerate(zip(split, whole)):
            share = work_of(a) / work_of(b)
            assert share == (1.0 if i in replicated else 0.5), \
                (model, r, i, a, b)


@pytest.mark.parametrize("model", MODELS)
def test_each_ranks_leaves_are_its_tensor_pieces(world, model):
    # sharding.tensor_piece, which chip_smoke.py's phase 18a cuts each
    # rank's params with, cuts them as the state does.
    for r, rep in enumerate(world[0]):
        for mesh in MESHES:
            assert rep["cases"][f"{model}.{mesh}"]["pieces"], (model, mesh, r)


def test_the_qkv_kernel_keeps_each_ranks_columns(world):
    for rep in world[0]:
        for mesh in MESHES:
            assert rep["cases"][f"diffusion.{mesh}"]["qkv_columns"], mesh


def test_uneven_splits_and_the_expert_axis_are_refused(world):
    for rep in world[0]:
        assert rep["uneven"] == (
            "leaf 'head/kernel': dim 1 ('mlp') of (16, 5) does not split "
            "into 2 equal parts over the tensor mesh axis (tensor=2); "
            "choose a tensor size that divides 5")
        assert rep["expert_model"] == (
            "the MNIST model routes nothing over the expert mesh axis; the "
            "mesh asks for expert=2")
        assert "does not declare expert-parallel support" in \
            rep["expert_trainer"]


def test_the_preflight_counts_each_ranks_share(world):
    reports = world[0]
    config = {"name": "diffusion-tensor",
              "entrypoint": "python3 model_def.py",
              "searcher": {"name": "single", "metric": "validation_loss",
                           "max_length": {"batches": 10}},
              "hyperparameters": {**DIFF_HP, "global_batch_size": BATCH,
                                  "mesh": MESHES["data2_tensor2"]},
              "resources": {"slots_per_trial": WORLD}}
    report = _preflight.preflight(
        config, context_dir=os.path.join(REPO, "examples", "diffusion_cuda"))
    assert [d.code for d in report.diagnostics if not d.suppressed] == []
    assert report.hbm["mesh"]["tensor"] == 2
    for rep in reports:
        local = rep["cases"]["diffusion.data2_tensor2"]["local_bytes"]
        assert report.hbm["params_bytes"] == local["params"]
        assert report.hbm["opt_state_bytes"] == local["opt_state"]


def load_example(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fit_one_process(tmp, Trial, hp):
    from determined_tpu_torch import core as tcore
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train.trial import TrialContext

    ctx = tcore.init(max_length=OTHER_STEPS, checkpoint_dir=str(tmp))
    state = Trainer(Trial(TrialContext(
        hparams=hp, core_context=ctx,
        global_batch_size=hp["global_batch_size"])), core_context=ctx,
        device="cpu").fit(report_period=1)
    ctx.close()
    return [r["metrics"] for r in ctx.train.local_training_metrics], \
        state.step


@pytest.mark.parametrize("name", ["mnist", "cifar"])
def test_the_other_trials_fit_over_tensor_and_context(tmp_path, world,
                                                      name):
    import chip_smoke

    run = world[0][0][f"fit_{name}"]
    assert (run["mesh"]["tensor"], run["mesh"]["context"]) == (2, 2)
    Trial, hp = {
        "mnist": (load_example("examples/mnist_cuda/model_def.py",
                               "torch_mnist_example").MNistTrial, MNIST_HP),
        "cifar": (chip_smoke.cifar_trial_class(), CIFAR_HP),
    }[name]
    metrics, step = fit_one_process(tmp_path, Trial, hp)
    assert run["step"] == step == OTHER_STEPS
    for key, rtol in (("loss", 1e-5), ("grad_norm", 5e-5)):
        np.testing.assert_allclose([m[key] for m in run["metrics"]],
                                   [m[key] for m in metrics], rtol=rtol,
                                   err_msg=f"{name} {key}")
