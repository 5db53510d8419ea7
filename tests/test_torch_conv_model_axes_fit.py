"""The diffusion example's trial through `Trainer.fit` over `tensor 2 x
context 2`: the port against the JAX Trainer, on the CPU.

One world of 4 gloo processes (a worker per rank; it imports only the
port) fits the example's trial 3 steps at `data 1 x context 2 x tensor
2` from numpy-drawn params (test_torch_conv_model_axes.py's), while the
test fits the JAX example's trial under the JAX Trainer on 4 of the 8
virtual CPU devices with the same mesh, params and batches. The batches
carry their timesteps and noise (the two packages draw from different
generators): the port's trial calls `loss_from_noise`, the JAX trial the
same MSE from `diffusion.apply` and `alpha_bars`. Every rank of the
world holds the whole batch (the data axis is 1).

Held as tests/test_torch_diffusion.py holds its fit: each step's loss
and the validation loss on the final params rtol 1e-5, grad norms 5e-5.
The params are not compared element by element with JAX's: adamw turns
either side's fp32 noise in a near-zero gradient into a step of about lr
(the attention's key bias has a zero gradient in exact arithmetic). The
chief's checkpoint (per rank, in the tensor layout) restores into one
process bit for bit against the world's final params.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from determined_tpu import core as jcore
from determined_tpu.train import Trainer as JTrainer
from determined_tpu.train.trial import TrialContext as JTrialContext
from determined_tpu_torch.models import diffusion as tdiff
from test_torch_conv_model_axes import (DIFF_HP, REPO, WORLD, flatten,
                                        jax_diffusion_loss, model_inputs)

FIT_MESH = {"data": 1, "context": 2, "tensor": 2}
FIT_STEPS, FIT_BATCH = 3, 4
FIT_HP = {**DIFF_HP, "global_batch_size": FIT_BATCH, "mesh": FIT_MESH}
TIMEOUT_S = 150

WORKER = r'''
import importlib.util, json, os, sys
import numpy as np
from determined_tpu_torch import core
from determined_tpu_torch.core._distributed import DistributedContext
from determined_tpu_torch.models import diffusion
from determined_tpu_torch.train import Trainer
from determined_tpu_torch.train import state as state_mod
from determined_tpu_torch.train.trial import TrialContext

rank, world, out, repo = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
FIT_HP = json.loads(sys.argv[5])


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


spec = importlib.util.spec_from_file_location(
    "diff_example", os.path.join(repo, "examples/diffusion_cuda/model_def.py"))
ddiff = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ddiff)
FIT = load("fit_batches")
PARAMS = unflatten(load("diffusion"))


class FitTrial(ddiff.DiffusionTrial):
    def init_params(self, rng):
        return diffusion.params_from_numpy(PARAMS, rng.device)

    def loss(self, params, batch, rng):
        return diffusion.loss_from_noise(params, batch["images"],
                                         batch["t"], batch["eps"], self.cfg)

    def build_training_data(self):
        return [{k: FIT[k][s] for k in FIT}
                for s in range(len(FIT["images"]) - 1)]

    def build_validation_data(self):
        return [{k: FIT[k][-1] for k in FIT}]

    def evaluate(self, params, batch):
        return {"validation_loss": self.loss(params, batch, None)[0]}


dist_ctx = DistributedContext.from_allocation(
    "file://" + os.path.join(out, "store"), world, rank, backend="gloo")
ctx = core.init(max_length=len(FIT["images"]) - 1, distributed=dist_ctx,
                checkpoint_dir=os.path.join(out, "ckpt"))
trainer = Trainer(FitTrial(TrialContext(
    hparams=FIT_HP, core_context=ctx,
    global_batch_size=FIT_HP["global_batch_size"])), core_context=ctx,
    device="cpu")
state = trainer.fit(report_period=1)
final = state_mod.unshard_state(state)
if rank == 0:
    np.savez(os.path.join(out, "fit.npz"),
             **flatten(diffusion.params_to_numpy(final.params)))
    with open(os.path.join(out, "report.json"), "w") as f:
        json.dump({
            "metrics": [r["metrics"] for r in
                        ctx.train.local_training_metrics],
            "validation": [r["metrics"] for r in
                           ctx.train.local_validation_metrics],
            "checkpoints": [r["uuid"] for r in
                            ctx.checkpoint.local_reported],
            "mesh": dict(zip(trainer.mesh.mesh_dim_names,
                             trainer.mesh.mesh.shape))}, f)
ctx.checkpoint.wait()

ctx.close()
'''


def load_example(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def inputs():
    """The UNet's params, and FIT_STEPS training batches and one
    validation batch carrying their timesteps and noise."""
    params = model_inputs()["diffusion"][0]
    rng = np.random.default_rng(5)
    n, size = FIT_STEPS + 1, 16
    fit = {"images": rng.uniform(-1, 1, (n, FIT_BATCH, size, size, 3))
           .astype(np.float32),
           "t": rng.integers(0, 64, (n, FIT_BATCH)).astype(np.int32),
           "eps": rng.normal(size=(n, FIT_BATCH, size, size, 3))
           .astype(np.float32)}
    return params, fit


@pytest.fixture(scope="module")
def world(tmp_path_factory, inputs, devices):
    """The port's fit in one world of 4, and the JAX Trainer's computed
    while it runs -> (the chief's report, the run dir, JAX's run)."""
    params, fit = inputs
    out = tmp_path_factory.mktemp("conv_fit_world")
    np.savez(out / "diffusion.npz", **flatten(params))
    np.savez(out / "fit_batches.npz", **fit)
    script = out / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(WORLD), str(out), REPO,
         json.dumps(FIT_HP)], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    try:
        ref = run_jax_fit(tmp_path_factory.mktemp("jax"), params, fit,
                          devices)
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return json.loads((out / "report.json").read_text()), out, ref


def run_jax_fit(tmp, params, fit, devices):
    jex = load_example("examples/diffusion/model_def.py", "jax_diff_example")
    train = [{k: v[s] for k, v in fit.items()} for s in range(FIT_STEPS)]
    val = [{k: v[-1] for k, v in fit.items()}]

    class JTrial(jex.DiffusionTrial):
        def init_params(self, rng):
            return jax.tree_util.tree_map(jnp.asarray, params)

        def loss(self, p, batch, rng):
            loss = jax_diffusion_loss(p, batch["images"], batch["t"],
                                      batch["eps"])
            return loss, {"loss": loss}

        def build_training_data(self):
            return train

        def build_validation_data(self):
            return val

        def evaluate(self, p, batch):
            return {"validation_loss": self.loss(p, batch, None)[0]}

    ctx = jcore.init(max_length=FIT_STEPS, checkpoint_dir=str(tmp))
    trainer = JTrainer(JTrial(JTrialContext(hparams=FIT_HP,
                                            core_context=ctx)),
                       core_context=ctx, devices=devices[:WORLD])
    trainer.fit(report_period=1)
    ctx.close()
    return ([r["metrics"] for r in ctx.train.local_training_metrics],
            [r["metrics"] for r in ctx.train.local_validation_metrics],
            dict(trainer.mesh.shape))


def test_fit_matches_the_jax_trainer(world):
    run, _, (jmetrics, jval, jmesh) = world
    assert (run["mesh"]["tensor"], run["mesh"]["context"]) == (2, 2)
    assert (jmesh["tensor"], jmesh["context"]) == (2, 2)
    assert len(run["metrics"]) == len(jmetrics) == FIT_STEPS
    for key, rtol in (("loss", 1e-5), ("grad_norm", 5e-5)):
        np.testing.assert_allclose([m[key] for m in run["metrics"]],
                                   [m[key] for m in jmetrics], rtol=rtol,
                                   err_msg=key)
    np.testing.assert_allclose(run["validation"][-1]["validation_loss"],
                               jval[-1]["validation_loss"], rtol=1e-5)
    assert run["checkpoints"] == [f"trial0-step{FIT_STEPS}"]


def test_the_checkpoint_restores_into_one_process(tmp_path, world, inputs):
    from determined_tpu_torch import core as tcore
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train.trial import TrialContext

    run, out, _ = world
    (sid,) = run["checkpoints"]
    shutil.copytree(out / "ckpt", tmp_path / "ckpt")
    tex = load_example("examples/diffusion_cuda/model_def.py",
                       "torch_diff_example")
    params = inputs[0]

    class Trial(tex.DiffusionTrial):
        def init_params(self, rng):
            return tdiff.params_from_numpy(params, rng.device)

    ctx = tcore.init(max_length=FIT_STEPS,
                     checkpoint_dir=str(tmp_path / "ckpt"))
    state = Trainer(Trial(TrialContext(hparams=DIFF_HP, core_context=ctx)),
                    core_context=ctx, device="cpu").fit(resume_from=sid)
    ctx.close()
    assert state.step == FIT_STEPS
    restored = flatten(tdiff.params_to_numpy(state.params))
    final = dict(np.load(out / "fit.npz"))
    assert set(restored) == set(final)
    for k, v in final.items():
        np.testing.assert_array_equal(restored[k], v, err_msg=k)

