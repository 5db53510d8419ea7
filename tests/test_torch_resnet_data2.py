"""The port's stateful ResNet trial over two processes on the `data` axis
against the JAX Trainer on two CPU devices.

The JAX model's BatchNorm takes `jnp.mean` over a batch-sharded array,
which under GSPMD is the mean over the whole global batch. The port's
ranks each hold half the rows and all-reduce the fp32 sum and sum of
squares over the batch axes (models/resnet.py), so both runs must report
the same losses and end with the same running stats and params. Per-rank
statistics would differ at the first step.

A tiny fp32 ResNet (test_torch_resnet.py's "basic" case) trains 4 steps
at a global batch of 8 through the port's `Trainer.fit` in 2 gloo
processes (`data=2`, one worker process per rank, each loader yielding
its rank's rows) and through the JAX Trainer on 2 of the 8 virtual CPU
devices with the same mesh and batches. Tolerances: losses rtol 1e-5;
the final stats and params within 1e-5 of each leaf's largest element.
"""

import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest

from determined_tpu import core as jcore
from determined_tpu.train import Trainer as JTrainer
from determined_tpu.train.trial import TrialContext as JTrialContext
from test_torch_resnet import (
    JaxResNet,
    assert_trees,
    fit_batches,
    numpy_state,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, WORLD, TIMEOUT_S = 4, 2, 120

WORKER = r'''
import json, os, pickle, sys
import numpy as np
import torch
from determined_tpu_torch import core
from determined_tpu_torch.core._distributed import DistributedContext
from determined_tpu_torch.models import resnet
from determined_tpu_torch.train import TorchTrial, Trainer, optim
from determined_tpu_torch.train.trial import TrialContext

rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
with open(os.path.join(out, "inputs.pkl"), "rb") as f:
    params, stats, batches, steps = pickle.load(f)
cfg = resnet.Config(stage_sizes=(1, 1), num_filters=8, n_classes=5,
                    dtype=torch.float32)


class Trial(TorchTrial):
    stateful = True

    def init_params(self, rng):
        return resnet.params_from_numpy(params, rng.device)

    def init_extra(self):
        return resnet.params_from_numpy(stats)

    def loss(self, p, extra, batch, rng):
        return resnet.loss_fn(p, extra, batch, rng, cfg)

    def param_logical_axes(self):
        return resnet.param_logical_axes(cfg)

    def supports_model_parallel(self):
        return False

    def optimizer(self):
        return optim.sgd(0.1, momentum=0.9)

    def build_training_data(self):
        d = self.context.distributed
        for b in batches:
            n = len(b["labels"]) // d.size
            yield {k: v[d.rank * n:(d.rank + 1) * n] for k, v in b.items()}


dist = DistributedContext.from_allocation(
    "file://" + os.path.join(out, "store"), world, rank, backend="gloo")
ctx = core.init(max_length=steps, checkpoint_dir=os.path.join(out, "ckpt"),
                distributed=dist)
trainer = Trainer(Trial(TrialContext(hparams={"mesh": {"data": world}},
                                     core_context=ctx)),
                  core_context=ctx, device="cpu")
state = trainer.fit(report_period=1)
from determined_tpu_torch.train.state import unshard_state
full = unshard_state(state)
if rank == 0:
    with open(os.path.join(out, "final.pkl"), "wb") as f:
        pickle.dump({"metrics": [r["metrics"] for r in
                                 ctx.train.local_training_metrics],
                     "params": resnet.params_to_numpy(full.params),
                     "stats": resnet.params_to_numpy(state.extra),
                     "mesh": list(trainer.mesh.mesh.shape)}, f)
ctx.close()
'''


@pytest.fixture(scope="module")
def inputs():
    params, stats = numpy_state("basic")
    return params, stats, fit_batches(STEPS)


def run_port(tmp_path, inputs):
    params, stats, batches = inputs
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump((params, stats, batches, STEPS), f)
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(WORLD), str(tmp_path)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    with open(tmp_path / "final.pkl", "rb") as f:
        return pickle.load(f)


def test_world_2_data_fit_has_global_batch_norm_stats(tmp_path, inputs):
    params, stats, batches = inputs
    report = run_port(tmp_path, inputs)
    assert report["mesh"] == [WORLD, 1, 1, 1, 1, 1]

    ctx = jcore.init(max_length=STEPS, checkpoint_dir=str(tmp_path / "jax"))
    trainer = JTrainer(JaxResNet(JTrialContext(hparams={"mesh": {
        "data": WORLD}}, core_context=ctx), (params, stats), batches),
        core_context=ctx, devices=jax.devices()[:WORLD])
    final = trainer.fit(report_period=1)
    ctx.close()
    assert dict(trainer.mesh.shape)["data"] == WORLD
    jrep = [r["metrics"] for r in ctx.train.local_training_metrics]
    assert len(jrep) == len(report["metrics"]) == STEPS
    np.testing.assert_allclose([r["loss"] for r in report["metrics"]],
                               [r["loss"] for r in jrep], rtol=1e-5)
    assert_trees(report["stats"], jax.device_get(final.extra), 1e-5, "stats")
    assert_trees(report["params"], jax.device_get(final.params), 1e-5,
                 "params")
