"""The port's Trainer over a mesh of several processes against the JAX
Trainer, on the CPU.

A tiny fp32 GPT-2 trial with numpy-drawn params trains 4 steps at a
global batch of 8 rows through `determined_tpu_torch.train.Trainer` in 2
processes with `fsdp=2` and in 4 with `data=2, fsdp=2` (a gloo process
group formed over a FileStore in the test's directory, one worker process
per rank, each loader yielding its rank's rows of the global batch), in
one process, and through the JAX Trainer on 2 and 4 of the 8 virtual CPU
devices with the same mesh and the same global batches. The losses and
grad norms each step reports, and the final params, must agree; then the
world-2 run's checkpoint (written by the chief in the one-process format)
restores into a one-process Trainer.

Tolerances, fp32 with the sums in other orders (across ranks, in
reduce-scatters, in XLA): losses and grad norms rtol 1e-5; params atol
1e-5 except where Adam turns fp32 noise into steps of about lr: the key
bias, whose gradient is 0 in exact arithmetic, held to 2 x lr x steps.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from determined_tpu import core as jcore
from determined_tpu.models import gpt2 as jgpt2
from determined_tpu.train import JaxTrial
from determined_tpu.train import Trainer as JTrainer
from determined_tpu.train.trial import TrialContext as JTrialContext

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = dict(vocab_size=64, n_positions=32, d_model=32, n_layer=2, n_head=2)
GLOBAL_BATCH, SEQ, STEPS, LR = 8, 17, 4, 1e-3
TIMEOUT_S = 120

# One rank of the port's run: written to the test's directory and run as
# `python worker.py RANK WORLD MESH_JSON DIR`. Imports only the port.
WORKER = r'''
import json, os, sys
import numpy as np
import torch
from determined_tpu_torch import core
from determined_tpu_torch.core._distributed import DistributedContext
from determined_tpu_torch.models import gpt2
from determined_tpu_torch.train import TorchTrial, Trainer, optim
from determined_tpu_torch.train import state as state_mod
from determined_tpu_torch.train.trial import TrialContext

rank, world, mesh, out = (int(sys.argv[1]), int(sys.argv[2]),
                          json.loads(sys.argv[3]), sys.argv[4])
DIMS = json.loads(sys.argv[5])
PREEMPT = len(sys.argv) > 6 and sys.argv[6] == "preempt"
GLOBAL_BATCH, SEQ, STEPS, LR = 8, 17, 4, 1e-3


class Trial(TorchTrial):
    def __init__(self, context):
        super().__init__(context)
        self.cfg = gpt2.Config(**DIMS, dtype=torch.float32)

    def init_params(self, rng):
        with np.load(os.path.join(out, "params.npz")) as f:
            flat = {k: f[k] for k in f.files}
        return gpt2.params_from_numpy(gpt2._unflatten(flat), rng.device)

    def loss(self, params, batch, rng):
        return gpt2.loss_fn(params, batch, self.cfg)

    def param_logical_axes(self):
        return gpt2.param_logical_axes(self.cfg)

    def optimizer(self):
        sched = optim.warmup_cosine_decay_schedule(0.0, LR, 1, 100)
        return optim.chain(optim.clip_by_global_norm(1.0),
                           optim.adamw(sched, b2=0.95, weight_decay=0.1))

    def build_training_data(self):
        d = self.context.distributed
        rows = GLOBAL_BATCH // d.size
        with np.load(os.path.join(out, "batches.npz")) as f:
            tokens = f["tokens"]
        for t in tokens:
            yield {"tokens": t[d.rank * rows:(d.rank + 1) * rows]}


dist = DistributedContext.from_allocation(
    "file://" + os.path.join(out, "store"), world, rank, backend="gloo")
ctx = core.init(max_length=STEPS, checkpoint_dir=os.path.join(out, "ckpt"),
                distributed=dist)
trial = Trial(TrialContext(hparams={"mesh": mesh}, core_context=ctx,
                           global_batch_size=GLOBAL_BATCH))
trainer = Trainer(trial, core_context=ctx, device="cpu")
if PREEMPT and dist.is_chief:
    ctx.preempt.force(deadline=600.0)  # as if the master had signalled
state = trainer.fit(report_period=1, preempt_period=2)
with open(os.path.join(out, f"step{rank}.txt"), "w") as f:
    f.write(str(state.step))
sharded = state_mod.is_sharded(state)
full = state_mod.unshard_state(state)
if rank == 0:
    np.savez(os.path.join(out, "final.npz"),
             **gpt2._flatten(gpt2.params_to_numpy(full.params)))
    with open(os.path.join(out, "report.json"), "w") as f:
        json.dump({"metrics": [r["metrics"] for r in
                               ctx.train.local_training_metrics],
                   "checkpoints": [r["uuid"] for r in
                                   ctx.checkpoint.local_reported],
                   "sharded": sharded,
                   "mesh": list(trainer.mesh.mesh.shape)}, f)
ctx.close()
'''


def numpy_params(seed=0, std=0.2):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda r: jgpt2.init(r, jgpt2.Config(
        **DIMS, dtype=jnp.float32)), jax.random.PRNGKey(0))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    out = {}
    for k, shape in flat.items():
        base = 1.0 if k.endswith("scale") else 0.0
        out[k] = (base + std * rng.normal(size=shape)).astype(np.float32)
    return out


def unflatten(flat):
    tree = {}
    for path, val in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def global_batches(seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, DIMS["vocab_size"],
                        size=(STEPS, GLOBAL_BATCH, SEQ)).astype(np.int32)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("fsdp_inputs")
    params, tokens = numpy_params(), global_batches()
    np.savez(d / "params.npz", **params)
    np.savez(d / "batches.npz", tokens=tokens)
    return d, params, tokens


def run_port(tmp_path, inputs, world, mesh, preempt=False):
    """The port's fit over `world` worker processes -> (report, final
    params, run dir)."""
    src, _, _ = inputs
    out = tmp_path / f"world{world}"
    out.mkdir()
    for name in ("params.npz", "batches.npz"):
        (out / name).write_bytes((src / name).read_bytes())
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), json.dumps(mesh),
         str(out), json.dumps(DIMS)] + (["preempt"] if preempt else []),
        env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
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
    report = json.loads((out / "report.json").read_text())
    with np.load(out / "final.npz") as f:
        final = {k: f[k] for k in f.files}
    return report, final, out


class JaxGPT2(JaxTrial):
    def __init__(self, context, params, tokens):
        super().__init__(context)
        self.cfg = jgpt2.Config(**DIMS, dtype=jnp.float32)
        self.params, self.tokens = params, tokens

    def init_params(self, rng):
        return jax.tree_util.tree_map(jnp.asarray, unflatten(self.params))

    def loss(self, params, batch, rng):
        return jgpt2.loss_fn(params, batch, self.cfg)

    def param_logical_axes(self):
        return jgpt2.param_logical_axes(self.cfg)

    def optimizer(self):
        sched = optax.warmup_cosine_decay_schedule(0.0, LR, 1, 100)
        return optax.chain(optax.clip_by_global_norm(1.0),
                           optax.adamw(sched, b2=0.95, weight_decay=0.1))

    def build_training_data(self):
        return [{"tokens": t} for t in self.tokens]


def run_jax(tmp_path, inputs, n_devices, mesh):
    _, params, tokens = inputs
    ctx = jcore.init(max_length=STEPS,
                     checkpoint_dir=str(tmp_path / f"jax{n_devices}"))
    trainer = JTrainer(JaxGPT2(JTrialContext(hparams={"mesh": mesh},
                                             core_context=ctx),
                               params, tokens),
                       core_context=ctx, devices=jax.devices()[:n_devices])
    state = trainer.fit(report_period=1)
    metrics = [r["metrics"] for r in ctx.train.local_training_metrics]
    flat = {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(state.params)[0]}
    ctx.close()
    return metrics, flat, dict(trainer.mesh.shape)


def port_one_process(tmp_path, inputs):
    """The same trial in this process, without a process group."""
    from determined_tpu_torch import core as tcore
    from determined_tpu_torch.models import gpt2 as tgpt2
    from determined_tpu_torch.train import TorchTrial, Trainer, optim
    from determined_tpu_torch.train.trial import TrialContext

    _, params, tokens = inputs

    class Trial(TorchTrial):
        cfg = tgpt2.Config(**DIMS, dtype=torch.float32)

        def init_params(self, rng):
            return tgpt2.params_from_numpy(unflatten(params), rng.device)

        def loss(self, p, batch, rng):
            return tgpt2.loss_fn(p, batch, self.cfg)

        def optimizer(self):
            sched = optim.warmup_cosine_decay_schedule(0.0, LR, 1, 100)
            return optim.chain(optim.clip_by_global_norm(1.0),
                               optim.adamw(sched, b2=0.95, weight_decay=0.1))

        def build_training_data(self):
            return [{"tokens": t} for t in tokens]

    ctx = tcore.init(max_length=STEPS, checkpoint_dir=str(tmp_path / "one"))
    state = Trainer(Trial(TrialContext(core_context=ctx)), core_context=ctx,
                    device="cpu").fit(report_period=1)
    metrics = [r["metrics"] for r in ctx.train.local_training_metrics]
    final = tgpt2._flatten(tgpt2.params_to_numpy(state.params))
    ctx.close()
    return metrics, final, Trial


def assert_metrics(got, want, what):
    assert len(got) == len(want) == STEPS, what
    for g, w in zip(got, want):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5,
                                       err_msg=f"{what} {key}")


def assert_params(got, want, what):
    assert set(got) == set(want), what
    d = DIMS["d_model"]
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if k == "blocks/qkv/bias":
            # The key third: Adam's steps on fp32 noise (module docstring).
            np.testing.assert_allclose(g[:, d:2 * d], w[:, d:2 * d],
                                       atol=2 * LR * STEPS, err_msg=what)
            g, w = np.delete(g, np.s_[d:2 * d], 1), \
                np.delete(w, np.s_[d:2 * d], 1)
        np.testing.assert_allclose(g, w, atol=1e-5, err_msg=f"{what} {k}")


FSDP2 = {"data": 1, "fsdp": 2}


@pytest.fixture(scope="module")
def world2(tmp_path_factory, inputs):
    """The world-2 fsdp=2 run, shared by the tests that read it."""
    return run_port(tmp_path_factory.mktemp("world2"), inputs, 2, FSDP2)


@pytest.mark.parametrize("world,mesh", [
    (2, FSDP2),
    (4, {"data": 2, "fsdp": 2}),
], ids=["fsdp2", "data2-fsdp2"])
def test_fit_over_processes_matches_jax_and_one_process(tmp_path, request,
                                                        inputs, world, mesh):
    report, final, out = request.getfixturevalue("world2") if world == 2 \
        else run_port(tmp_path, inputs, world, mesh)
    assert report["sharded"] is True
    jmetrics, jfinal, jmesh = run_jax(tmp_path, inputs, world, mesh)
    assert jmesh["data"] == mesh["data"] and jmesh["fsdp"] == mesh["fsdp"]
    assert report["mesh"] == [mesh["data"], 1, mesh["fsdp"], 1, 1, 1]
    assert_metrics(report["metrics"], jmetrics, f"world {world} vs JAX")
    assert_params(final, jfinal, f"world {world} vs JAX")
    one_metrics, one_final, _ = port_one_process(tmp_path, inputs)
    assert_metrics(report["metrics"], one_metrics,
                   f"world {world} vs one process")
    assert_params(final, one_final, f"world {world} vs one process")
    assert report["checkpoints"] == [f"trial0-step{STEPS}"]


def test_a_world_2_checkpoint_restores_into_one_process(tmp_path, inputs,
                                                        world2):
    from determined_tpu_torch import core as tcore
    from determined_tpu_torch.models import gpt2 as tgpt2
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train.trial import TrialContext

    report, final, out = world2
    (sid,) = report["checkpoints"]
    _, _, Trial = port_one_process(tmp_path, inputs)
    # A copy: the restoring run must not add to the shared run's storage.
    shutil.copytree(out / "ckpt", tmp_path / "ckpt")
    ctx = tcore.init(max_length=STEPS, checkpoint_dir=str(tmp_path / "ckpt"))
    trainer = Trainer(Trial(TrialContext(core_context=ctx)),
                      core_context=ctx, device="cpu")
    state = trainer.fit(resume_from=sid)  # already at max_length: no step
    ctx.close()
    assert state.step == STEPS
    restored = tgpt2._flatten(tgpt2.params_to_numpy(state.params))
    for k, v in final.items():
        np.testing.assert_array_equal(restored[k], v, err_msg=k)


def test_unported_axes_and_a_world_without_a_group_raise(tmp_path,
                                                         monkeypatch):
    import torch.distributed as dist

    from determined_tpu_torch import core as tcore
    from determined_tpu_torch.core._distributed import (
        DistributedContext,
        make_thread_transports,
    )
    from determined_tpu_torch.train import Trainer

    _, _, Trial = port_one_process(tmp_path, (None, numpy_params(),
                                              global_batches()))
    from determined_tpu_torch.train.trial import TrialContext

    # A world of 2 with a process group: tensor/context/pipeline/expert
    # above 1 name ROADMAP item 7; data and fsdp resolve.
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    for axis in ("tensor", "context", "pipeline", "expert"):
        trial = Trial(TrialContext(hparams={"mesh": {axis: 2, "data": 1}}))
        with pytest.raises(ValueError, match="item 7"):
            Trainer(trial, device="cpu")
    for mesh in ({"fsdp": 2, "data": 1}, {"data": 2}, {}):
        trainer = Trainer(Trial(TrialContext(hparams={"mesh": mesh})),
                          device="cpu")
        assert trainer.mesh_config.data * trainer.mesh_config.fsdp == 2
    with pytest.raises(ValueError, match="2 processes"):
        Trainer(Trial(TrialContext(hparams={"mesh": {"data": 4}})),
                device="cpu")
    monkeypatch.undo()
    # A core context of 2 ranks without a process group never trains
    # alone.
    t = make_thread_transports(2)
    ctx = tcore.init(max_length=1, checkpoint_dir=str(tmp_path / "c"),
                     distributed=DistributedContext.for_test(0, 2, t[0]))
    with pytest.raises(RuntimeError, match="no torch.distributed process"):
        Trainer(Trial(TrialContext(core_context=ctx)), core_context=ctx,
                device="cpu")


def test_a_preemption_is_the_chiefs_and_every_rank_checkpoints(tmp_path,
                                                              inputs):
    """Only the chief sees the (forced) signal; the broadcast flag stops
    both ranks at the first poll (step 2), where they save together."""
    report, _, out = run_port(tmp_path, inputs, 2, FSDP2, preempt=True)
    steps = [int((out / f"step{r}.txt").read_text()) for r in range(2)]
    assert steps == [2, 2]
    assert report["checkpoints"] == ["trial0-step2"]
    assert (out / "ckpt" / "trial0-step2" / "COMMIT").exists()
