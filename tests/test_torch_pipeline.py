"""GPipe over the `pipeline` mesh axis: the port against the JAX package,
on the CPU.

One world of 4 gloo processes (a worker per rank over a FileStore in the
test's directory; the worker imports only the port, and runs under a
timeout, so a send/receive order that deadlocks fails the test instead of
hanging it) runs every case:

  - `parallel.pipeline.pipeline_apply` with the JAX tests' tanh block
    (tests/test_pipeline.py) at pipeline 4 and at data 2 x pipeline 2
    with 2, 4 and 8 microbatches: the output and the gradients in w and x
    against JAX's `pipeline_apply` and `jax.grad` on the same mesh (4 of
    the 8 virtual CPU devices). w is a plain tensor on every rank, so a
    stage's gradient is its layers' slice (0 elsewhere) for its rows, and
    x's is stage 0's; the ranks' gradients sum to the whole.
  - a TINY fp32 GPT-2 (4 layers, an uneven 65-row vocab, numpy-drawn
    params) laid out by `create_train_state` at pipeline 4, data 2 x
    pipeline 2, pipeline 2 x tensor 2 and fsdp 2 x pipeline 2 (with
    remat): `gpt2.apply_pipelined`'s logits, `loss_fn_pipelined` and
    every gradient (gathered into the one-process layout) against JAX's
    `apply_pipelined`, `loss_fn_pipelined` and `jax.grad` on the same
    mesh, and against `jax.grad(loss_fn)` on one device. `wte`'s gradient
    is the head's plus the embedding's.
  - the Trainer: `fit` 4 steps at data 2 x pipeline 2 with 4
    microbatches and the op-end validation (tests/test_trainer.py's
    pipelined hooks, `loss_pipelined` and `evaluate_pipelined`) against
    the JAX Trainer on the same mesh and batches; its checkpoint restores
    into one process bit for bit; a trial without `evaluate_pipelined`
    validates through `evaluate` on gathered params to the same value.
  - the refusals: layers not divisible by stages, a batch not divisible
    by the microbatches, a microbatch not divisible by the batch
    sharding, and MoE under pipeline.

test_torch_pipeline_single.py holds the checks that run in one process:
`pipeline_microbatches_default` against JAX's over a grid, the Trainer's
refusals, the one-process walk of the schedule, and the lint's DTL101 for
a host read in `loss_pipelined`.

Tolerances, fp32 with the sums in other orders (across ranks, over the
vocab slices, in XLA), those of tests/test_torch_tensor_parallel.py:
outputs and logits atol 2e-5, gradients 1e-5 of each leaf's largest
element; losses and grad norms rtol 1e-5; params atol 1e-5, except the
key bias, whose gradient is 0 in exact arithmetic, so Adam turns either
side's fp32 noise into steps of about lr: held to 2 x lr x steps.
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
from determined_tpu.parallel import pipeline as jpipeline
from determined_tpu.parallel.mesh import MeshConfig as JMeshConfig
from determined_tpu.parallel.mesh import create_mesh as jcreate_mesh
from determined_tpu.train import JaxTrial
from determined_tpu.train import Trainer as JTrainer
from determined_tpu.train.trial import TrialContext as JTrialContext

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
DIMS = dict(vocab_size=65, n_positions=32, d_model=32, n_layer=4, n_head=4)
GLOBAL_BATCH, SEQ, M = 8, 17, 2
TANH_CASES = {  # name: (mesh, layers, width, global batch, microbatches)
    "pipeline4": ({"data": 1, "pipeline": 4}, 4, 16, 8, 4),
    "data2_pipeline2_m2": ({"data": 2, "pipeline": 2}, 4, 8, 16, 2),
    "data2_pipeline2_m4": ({"data": 2, "pipeline": 2}, 4, 8, 16, 4),
    "data2_pipeline2_m8": ({"data": 2, "pipeline": 2}, 4, 8, 16, 8),
}
MODEL_CASES = {  # name: (mesh, remat)
    "pipeline4": ({"data": 1, "pipeline": 4}, False),
    "data2_pipeline2": ({"data": 2, "pipeline": 2}, False),
    "pipeline2_tensor2": ({"data": 1, "pipeline": 2, "tensor": 2}, False),
    "fsdp2_pipeline2_remat": ({"data": 1, "fsdp": 2, "pipeline": 2}, True),
}
# The Trainer: tests/test_trainer.py's tiny model and hooks (4
# microbatches), fp32, at data 2 x pipeline 2.
FIT_DIMS = dict(vocab_size=512, n_positions=128, d_model=64, n_layer=2,
                n_head=4)
FIT_MESH = {"data": 2, "pipeline": 2}
FIT_M, STEPS, LR = 4, 4, 1e-3
TIMEOUT_S = 150

WORKER = r'''
import json, os, sys
import numpy as np
import torch
from determined_tpu_torch import core
from determined_tpu_torch.core._distributed import DistributedContext
from determined_tpu_torch.models import gpt2
from determined_tpu_torch.parallel import pipeline
from determined_tpu_torch.parallel.mesh import (
    MeshConfig, axis_group, batch_shard, create_mesh)
from determined_tpu_torch.train import TorchTrial, Trainer, optim
from determined_tpu_torch.train import state as state_mod
from determined_tpu_torch.train.step import global_mean
from determined_tpu_torch.train.trial import TrialContext

rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
DIMS, TANH, CASES, FIT_DIMS, FIT_MESH = (json.loads(a) for a in sys.argv[4:9])
GLOBAL_BATCH, M, FIT_M, STEPS, LR = 8, 2, 4, 4, 1e-3


def load(name):
    with np.load(os.path.join(out, name)) as f:
        return {k: f[k] for k in f.files}


TANH_IN, FLAT, FIT_FLAT, TOKENS = (load("tanh.npz"), load("params.npz"),
                                   load("fit_params.npz"), load("tokens.npz"))
dist_ctx = DistributedContext.from_allocation(
    "file://" + os.path.join(out, "store"), world, rank, backend="gloo")
report = {"tanh": {}, "cases": {}}


def rows_of(mc, a, n_rows):
    i, n = batch_shard(mc, rank, world)
    return a[i * n_rows // n:(i + 1) * n_rows // n], [i, n]


# pipeline_apply with the tanh block.
for name, (sizes, L, D, B, m) in TANH.items():
    mc = MeshConfig(**sizes)
    mesh = create_mesh(mc, "cpu")
    w = torch.from_numpy(TANH_IN[name + "/w"]).requires_grad_()
    x, rows = rows_of(mc, TANH_IN[name + "/x"], B)
    ct, _ = rows_of(mc, TANH_IN[name + "/ct"], B)
    x = torch.from_numpy(x).requires_grad_()
    y = pipeline.pipeline_apply(lambda xx, wl: torch.tanh(xx @ wl), w, x,
                                mesh=mesh, num_microbatches=m)
    gw, gx = torch.autograd.grad((y * torch.from_numpy(ct)).sum(), [w, x])
    stage = axis_group(mesh, "pipeline")
    np.savez(os.path.join(out, f"tanh_{name}.rank{rank}.npz"), y=y.detach(),
             gw=gw, gx=gx)
    report["tanh"][name] = {"rows": rows, "stage": [stage.index,
                                                    stage.size]}


def params(flat=None, device=None):
    return gpt2.params_from_numpy(gpt2._unflatten(dict(flat or FLAT)),
                                  device)


# The model over each mesh.
for name, (sizes, remat) in CASES.items():
    cfg = gpt2.Config(**DIMS, dtype=torch.float32, remat=remat)
    mc = MeshConfig(**sizes)
    mesh = create_mesh(mc, "cpu")
    state = state_mod.create_train_state(
        lambda g: params(), optim.adamw(LR), torch.Generator(), mesh=mesh,
        param_logical_axes=gpt2.param_logical_axes(cfg))
    rows, where = rows_of(mc, TOKENS["model"], GLOBAL_BATCH)
    rows = torch.from_numpy(rows)
    loss = gpt2.loss_fn_pipelined(state.params, {"tokens": rows}, cfg, mesh,
                                  num_microbatches=M)
    grads = torch.autograd.grad(loss, state.leaves())
    full = state_mod.full_leaves(state, list(grads))
    with torch.no_grad():
        logits = gpt2.apply_pipelined(state.params, rows[:, :-1], cfg, mesh,
                                      num_microbatches=M)
    (mean,) = global_mean([loss])
    np.savez(os.path.join(out, f"{name}.rank{rank}.npz"),
             logits=logits.numpy(), loss=loss.detach().numpy(),
             mean=mean.numpy(),
             **{k: g.numpy() for k, g in zip(gpt2._flatten(params()), full)})
    report["cases"][name] = {"rows": where}
    del state, grads

# What pipeline_apply and the model refuse (before any transfer).
mc = MeshConfig(data=2, pipeline=2)
mesh = create_mesh(mc, "cpu")
refused = []
block = lambda xx, wl: torch.tanh(xx @ wl)  # noqa: E731
for w, x, m in ((torch.zeros(3, 8, 8), torch.zeros(8, 8), 2),
                (torch.zeros(4, 8, 8), torch.zeros(4, 8), 3),
                (torch.zeros(4, 8, 8), torch.zeros(4, 8), 8)):
    try:
        pipeline.pipeline_apply(block, w, x, mesh=mesh, num_microbatches=m)
        refused.append(None)
    except ValueError as e:
        refused.append(str(e))
try:
    gpt2.loss_fn_pipelined(params(), {"tokens": torch.zeros(
        (4, 9), dtype=torch.int64)}, gpt2.Config(**DIMS, num_experts=4),
        mesh)
    refused.append(None)
except NotImplementedError as e:
    refused.append(str(e))
report["refused"] = refused


# The Trainer at FIT_MESH: tests/test_trainer.py's pipelined hooks.
class Trial(TorchTrial):
    def __init__(self, context):
        super().__init__(context)
        self.cfg = gpt2.Config(**FIT_DIMS, dtype=torch.float32)

    def init_params(self, rng):
        return params(FIT_FLAT, rng.device)

    def loss(self, p, batch, rng):
        return gpt2.loss_fn(p, batch, self.cfg)

    def loss_pipelined(self, p, batch, rng, mesh):
        return gpt2.loss_fn_pipelined(p, batch, self.cfg, mesh,
                                      num_microbatches=FIT_M)

    def evaluate(self, p, batch):
        return {"loss": gpt2.loss_fn(p, batch, self.cfg)}

    def evaluate_pipelined(self, p, batch, mesh):
        return {"loss": gpt2.loss_fn_pipelined(p, batch, self.cfg, mesh,
                                               num_microbatches=FIT_M)}

    def param_logical_axes(self):
        return gpt2.param_logical_axes(self.cfg)

    def optimizer(self):
        sched = optim.warmup_cosine_decay_schedule(0.0, LR, 1, 100)
        return optim.chain(optim.clip_by_global_norm(1.0),
                           optim.adamw(sched, b2=0.95, weight_decay=0.1))

    def _rows(self, tokens):
        d = self.context.distributed
        i, n = batch_shard(self.mesh_config(), d.rank, d.size)
        k = len(tokens[0]) // n
        for t in tokens:
            yield {"tokens": t[i * k:(i + 1) * k]}

    def build_training_data(self):
        return self._rows(TOKENS["train"])

    def build_validation_data(self):
        return self._rows(TOKENS["val"])


class PlainEval(Trial):
    evaluate_pipelined = TorchTrial.evaluate_pipelined


ctx = core.init(max_length=STEPS, distributed=dist_ctx,
                checkpoint_dir=os.path.join(out, "ckpt"))
trainer = Trainer(Trial(TrialContext(
    hparams={"mesh": FIT_MESH}, core_context=ctx,
    global_batch_size=GLOBAL_BATCH)), core_context=ctx, device="cpu")
state = trainer.fit(report_period=1)
full = state_mod.unshard_state(state)
validation = [r["metrics"] for r in ctx.train.local_validation_metrics]
# The same state validated through `evaluate` on gathered params.
plain = Trainer(PlainEval(TrialContext(
    hparams={"mesh": FIT_MESH}, core_context=ctx,
    global_batch_size=GLOBAL_BATCH)), core_context=ctx, device="cpu")
plain._build(0)
plain.state = state
gathered = plain._validate_inner(ctx, STEPS)
if rank == 0:
    np.savez(os.path.join(out, "fit.npz"),
             **gpt2._flatten(gpt2.params_to_numpy(full.params)))
    report["fit"] = {
        "metrics": [r["metrics"] for r in ctx.train.local_training_metrics],
        "validation": validation,
        "gathered": gathered,
        "checkpoints": [r["uuid"] for r in ctx.checkpoint.local_reported],
        "mesh": dict(zip(trainer.mesh.mesh_dim_names,
                         trainer.mesh.mesh.shape))}
ctx.checkpoint.wait()
with open(os.path.join(out, f"report{rank}.json"), "w") as f:
    json.dump(report, f)
ctx.close()
'''


def numpy_params(dims, seed=0, std=0.2):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda r: jgpt2.init(r, jgpt2.Config(
        **dims, dtype=jnp.float32)), jax.random.PRNGKey(0))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        k = "/".join(str(getattr(p, "key", p)) for p in path)
        base = 1.0 if k.endswith("scale") else 0.0
        out[k] = (base + std * rng.normal(size=leaf.shape)).astype(np.float32)
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


def flatten(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_mesh(sizes, devices):
    return jcreate_mesh(JMeshConfig(**sizes).resolve(WORLD), devices[:WORLD])


def tanh_block(x, w):
    return jnp.tanh(x @ w)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    tanh = {}
    for name, (_, L, D, B, _) in TANH_CASES.items():
        tanh[name + "/w"] = (0.3 * rng.normal(size=(L, D, D))).astype(
            np.float32)
        tanh[name + "/x"] = rng.normal(size=(B, D)).astype(np.float32)
        tanh[name + "/ct"] = rng.normal(size=(B, D)).astype(np.float32)
    tokens = {
        "model": rng.integers(0, DIMS["vocab_size"],
                              size=(GLOBAL_BATCH, SEQ)).astype(np.int32),
        "train": rng.integers(0, 64, size=(STEPS, GLOBAL_BATCH, SEQ)
                              ).astype(np.int32),
        "val": rng.integers(0, 64, size=(2, GLOBAL_BATCH, SEQ)
                            ).astype(np.int32),
    }
    return tanh, numpy_params(DIMS), numpy_params(FIT_DIMS, seed=1), tokens


def start_world(out, inputs):
    """The world's 4 worker processes, started on the inputs in `out`."""
    tanh, params, fit_params, tokens = inputs
    np.savez(out / "tanh.npz", **tanh)
    np.savez(out / "params.npz", **params)
    np.savez(out / "fit_params.npz", **fit_params)
    np.savez(out / "tokens.npz", **tokens)
    script = out / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    args = [json.dumps(a) for a in (DIMS, TANH_CASES, MODEL_CASES, FIT_DIMS,
                                    FIT_MESH)]
    return [subprocess.Popen(
        [sys.executable, str(script), str(r), str(WORLD), str(out), *args],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]


@pytest.fixture(scope="module")
def world(tmp_path_factory, inputs, devices):
    """Every case in one world of 4, and the JAX side computed while it
    runs -> (the ranks' reports, the run dir, the JAX results)."""
    out = tmp_path_factory.mktemp("pipeline_world")
    procs = start_world(out, inputs)
    logs = []
    try:
        ref = jax_side(inputs, devices, tmp_path_factory.mktemp("jax"))
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


def jax_side(inputs, devices, tmp):
    """JAX's pipeline_apply and gradients for the tanh cases; its
    pipelined logits, loss and gradients for the model cases and on one
    device; and the JAX Trainer's run."""
    tanh, params, fit_params, tokens = inputs
    ref = {"tanh": {}, "model": {}}
    for name, (sizes, _, _, _, m) in TANH_CASES.items():
        w, x, ct = (jnp.asarray(tanh[f"{name}/{k}"])
                    for k in ("w", "x", "ct"))
        mesh = jax_mesh(sizes, devices)
        with jax.sharding.set_mesh(mesh):
            def f(w, x, mesh=mesh, m=m):
                return jpipeline.pipeline_apply(tanh_block, w, x, mesh=mesh,
                                                num_microbatches=m)

            ref["tanh"][name] = jax.tree_util.tree_map(np.asarray, jax.jit(
                lambda w, x, f=f: (f(w, x), jax.grad(
                    lambda w, x: jnp.sum(f(w, x) * ct),
                    argnums=(0, 1))(w, x)))(w, x))
    batch = {"tokens": jnp.asarray(tokens["model"])}
    jp = jax.tree_util.tree_map(jnp.asarray, unflatten(params))
    for name, (sizes, remat) in MODEL_CASES.items():
        cfg = jgpt2.Config(**DIMS, dtype=jnp.float32, remat=remat)
        mesh = jax_mesh(sizes, devices)
        with jax.sharding.set_mesh(mesh):
            loss, grads, logits = jax.jit(lambda p: (*jax.value_and_grad(
                lambda q: jgpt2.loss_fn_pipelined(q, batch, cfg, mesh,
                                                  num_microbatches=M))(p),
                jgpt2.apply_pipelined(p, batch["tokens"][:, :-1], cfg, mesh,
                                      num_microbatches=M)))(jp)
        ref["model"][name] = (float(loss), flatten(grads), np.asarray(logits))
    cfg = jgpt2.Config(**DIMS, dtype=jnp.float32)
    loss, grads, logits = jax.jit(lambda p: (*jax.value_and_grad(
        lambda q: jgpt2.loss_fn(q, batch, cfg))(p),
        jgpt2.apply(p, batch["tokens"][:, :-1], cfg)))(jp)
    ref["one"] = (float(loss), flatten(grads), np.asarray(logits))
    ctx = jcore.init(max_length=STEPS, checkpoint_dir=str(tmp / "ckpt"))
    trainer = JTrainer(JaxPipelined(JTrialContext(core_context=ctx),
                                    fit_params, tokens),
                       core_context=ctx, devices=jax.devices()[:WORLD])
    state = trainer.fit(report_period=1)
    ref["fit"] = {
        "metrics": [r["metrics"] for r in ctx.train.local_training_metrics],
        "validation": [r["metrics"] for r in
                       ctx.train.local_validation_metrics],
        "final": flatten(state.params), "mesh": dict(trainer.mesh.shape)}
    ctx.close()
    return ref


# ------------------------------------------------------- pipeline_apply


@pytest.mark.parametrize("name", list(TANH_CASES))
def test_pipeline_apply_matches_jax(world, name):
    reports, out, ref = world
    sizes, L, D, B, m = TANH_CASES[name]
    y, (gw, gx) = ref["tanh"][name]
    ranks = [dict(np.load(out / f"tanh_{name}.rank{r}.npz"))
             for r in range(WORLD)]
    sum_w, got_x = np.zeros_like(gw), np.zeros_like(gx)
    per = L // reports[0]["tanh"][name]["stage"][1]
    for r, rank in enumerate(ranks):
        (i, n), (s, _) = (reports[r]["tanh"][name][k]
                          for k in ("rows", "stage"))
        block = slice(i * B // n, (i + 1) * B // n)
        # Every stage holds the output; its layers' gradient only, and x's
        # on stage 0 only.
        np.testing.assert_allclose(rank["y"], y[block], atol=2e-5,
                                   err_msg=f"{name} y, rank {r}")
        outside = np.delete(rank["gw"], np.s_[s * per:(s + 1) * per], 0)
        assert not outside.any(), (name, r)
        sum_w += rank["gw"]
        if s == 0:
            got_x[block] = rank["gx"]
        else:
            assert not rank["gx"].any(), (name, r)
    for got, want, what in ((sum_w, gw, "w"), (got_x, gx, "x")):
        err = np.abs(got - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (name, what, err)


def test_pipeline_apply_refuses_what_jax_refuses(world):
    reports = world[0]
    for rep in reports:
        layers, batch, micro, moe = rep["refused"]
        assert "3 layers not divisible by 2 stages" in layers
        assert "batch 8 not divisible by 3 microbatches" in batch
        assert "microbatch size 1 (batch 8 / 8 microbatches) must stay " \
            "divisible by the 2-way batch sharding" in micro
        assert "MoE blocks are not supported under pipeline" in moe


# ------------------------------------------------------------- the model


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_model_matches_jax(world, name):
    reports, out, ref = world
    loss, grads, logits = ref["model"][name]
    loss1, grads1, logits1 = ref["one"]
    ranks = [dict(np.load(out / f"{name}.rank{r}.npz")) for r in range(WORLD)]
    got = np.zeros(np.shape(logits), np.float32)
    for r in range(WORLD):
        i, n = reports[r]["cases"][name]["rows"]
        got[i * GLOBAL_BATCH // n:(i + 1) * GLOBAL_BATCH // n] = \
            ranks[r]["logits"]
    for want, what in ((logits, "mesh"), (logits1, "one")):
        np.testing.assert_allclose(got, want, atol=2e-5,
                                   err_msg=f"{name} logits, {what}")
    for r in range(WORLD):
        # Every stage reports its rows' loss; the mean is the global one.
        for want in (loss, loss1):
            np.testing.assert_allclose(ranks[r]["mean"], want, rtol=1e-5,
                                       err_msg=f"{name} loss, rank {r}")
    for want_tree, what in ((grads, "mesh"), (grads1, "one")):
        for k, want in want_tree.items():
            scale = np.abs(want).max()
            for r in range(WORLD):
                err = np.abs(ranks[r][k] - want).max()
                assert err <= 1e-5 * scale, (name, what, k, r, err, scale)


# ----------------------------------------------------------- the trainer


class JaxPipelined(JaxTrial):
    """tests/test_trainer.py's PipelinedTinyGPT2Trial's hooks, fp32, with
    numpy params, the fsdp tests' optimizer and these batches."""

    def __init__(self, context, params, tokens):
        super().__init__(context)
        self.cfg = jgpt2.Config(**FIT_DIMS, dtype=jnp.float32)
        self.params, self.tokens = params, tokens

    def init_params(self, rng):
        return jax.tree_util.tree_map(jnp.asarray, unflatten(self.params))

    def loss(self, params, batch, rng):
        return jgpt2.loss_fn(params, batch, self.cfg)

    def loss_pipelined(self, params, batch, rng, mesh):
        return jgpt2.loss_fn_pipelined(params, batch, self.cfg, mesh,
                                       num_microbatches=FIT_M)

    def evaluate(self, params, batch):
        return {"loss": jgpt2.loss_fn(params, batch, self.cfg)}

    def evaluate_pipelined(self, params, batch, mesh):
        return {"loss": jgpt2.loss_fn_pipelined(
            params, batch, self.cfg, mesh, num_microbatches=FIT_M)}

    def param_logical_axes(self):
        return jgpt2.param_logical_axes(self.cfg)

    def mesh_config(self):
        return JMeshConfig(**FIT_MESH)

    def optimizer(self):
        sched = optax.warmup_cosine_decay_schedule(0.0, LR, 1, 100)
        return optax.chain(optax.clip_by_global_norm(1.0),
                           optax.adamw(sched, b2=0.95, weight_decay=0.1))

    def build_training_data(self):
        return [{"tokens": t} for t in self.tokens["train"]]

    def build_validation_data(self):
        return [{"tokens": t} for t in self.tokens["val"]]


def test_fit_matches_the_jax_trainer(world):
    reports, out, ref = world
    run, jrun = reports[0]["fit"], ref["fit"]
    assert run["mesh"]["pipeline"] == jrun["mesh"]["pipeline"] == 2
    assert run["mesh"]["data"] == jrun["mesh"]["data"] == 2
    assert len(run["metrics"]) == len(jrun["metrics"]) == STEPS
    for g, w in zip(run["metrics"], jrun["metrics"]):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5,
                                       err_msg=key)
    assert len(run["validation"]) == len(jrun["validation"]) == 1
    got_val = run["validation"][0]["validation_loss"]
    np.testing.assert_allclose(got_val,
                               jrun["validation"][0]["validation_loss"],
                               rtol=1e-5)
    # Validation through `evaluate` on gathered params: the same value.
    np.testing.assert_allclose(run["gathered"]["validation_loss"], got_val,
                               rtol=1e-6)
    got = dict(np.load(out / "fit.npz"))
    assert set(got) == set(jrun["final"])
    d = FIT_DIMS["d_model"]
    for k, w in jrun["final"].items():
        g = got[k]
        if k == "blocks/qkv/bias":
            # The key third: Adam's steps on fp32 noise (module docstring).
            np.testing.assert_allclose(g[:, d:2 * d], w[:, d:2 * d],
                                       atol=2 * LR * STEPS)
            g, w = np.delete(g, np.s_[d:2 * d], 1), \
                np.delete(w, np.s_[d:2 * d], 1)
        np.testing.assert_allclose(g, w, atol=1e-5, err_msg=k)
    assert run["checkpoints"] == [f"trial0-step{STEPS}"]


def test_the_checkpoint_restores_into_one_process(tmp_path, world, inputs):
    from determined_tpu_torch import core as tcore
    from determined_tpu_torch.models import gpt2 as tgpt2
    from determined_tpu_torch.train import TorchTrial, Trainer, optim
    from determined_tpu_torch.train.trial import TrialContext

    reports, out, _ = world
    _, _, params, _ = inputs
    (sid,) = reports[0]["fit"]["checkpoints"]
    final = dict(np.load(out / "fit.npz"))
    shutil.copytree(out / "ckpt", tmp_path / "ckpt")

    class Trial(TorchTrial):
        cfg = tgpt2.Config(**FIT_DIMS, dtype=torch.float32)

        def init_params(self, rng):
            return tgpt2.params_from_numpy(unflatten(params), rng.device)

        def loss(self, p, batch, rng):
            return tgpt2.loss_fn(p, batch, self.cfg)

        def optimizer(self):
            sched = optim.warmup_cosine_decay_schedule(0.0, LR, 1, 100)
            return optim.chain(optim.clip_by_global_norm(1.0),
                               optim.adamw(sched, b2=0.95, weight_decay=0.1))

        def build_training_data(self):
            return []

    ctx = tcore.init(max_length=STEPS, checkpoint_dir=str(tmp_path / "ckpt"))
    state = Trainer(Trial(TrialContext(core_context=ctx)), core_context=ctx,
                    device="cpu").fit(resume_from=sid)  # at max_length
    ctx.close()
    assert state.step == STEPS
    restored = tgpt2._flatten(tgpt2.params_to_numpy(state.params))
    for k, v in final.items():
        np.testing.assert_array_equal(restored[k], v, err_msg=k)


