"""GPT-2 over the `tensor` and `context` mesh axes: the port against the
JAX package, on the CPU.

A world of 4 gloo processes (a worker per rank over a FileStore in the
test's directory; the worker imports only the port) runs the cases, one
world for the model cases here and one for the Trainer's fits in
test_torch_tensor_parallel_fit.py:

  - the model: a TINY fp32 GPT-2 with an uneven vocab (65 rows over
    tensor 2: 33 and 32) and numpy-drawn params, laid out by
    `train/state.create_train_state` over `data 2 x tensor 2`, `fsdp 2 x
    tensor 2` and `context 2 x tensor 2` (ring and Ulysses attention).
    Its logits (`gpt2.apply`), loss and every gradient (`gpt2.loss_fn`,
    the gradients gathered into the one-process layout) are held to
    `determined_tpu.models.gpt2.apply` and `jax.grad` of its `loss_fn`
    under the same mesh on 4 of the 8 virtual CPU devices. The state's
    tensor layout must round-trip bit for bit, and each rank's qkv slice
    must hold the q, k and v columns of its own heads.
  - the Trainer: `fit` 4 steps at `tensor 2 x context 2`, once with
    `attention_impl: ring` and once with `ulysses`, against the JAX
    Trainer with the same trial, mesh and batches. The JAX Trainer cannot
    lay a 65-row table over tensor 2 (its jit's output shardings need an
    even split), so these two runs use 64 rows; a third, ring with the
    65 rows, is held to the port's one-process `fit`, and the model
    cases above hold the uneven table to JAX's loss and `jax.grad` on
    the mesh. The ring run's checkpoint (written by the chief in the
    one-process format) restores into one process bit for bit.

Tolerances, fp32 with the sums in other orders (across ranks, over the
vocab and head slices, in XLA): logits atol 2e-5, gradients 1e-5 of each
leaf's largest element; losses and grad norms rtol 1e-5; params atol
1e-5, except the key bias, whose gradient is 0 in exact arithmetic, so
Adam turns either side's fp32 noise into steps of about lr: it is held
to 2 x lr x steps (tests/test_torch_fsdp_trainer.py's rule).
"""

import json
import os
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
from determined_tpu.parallel.mesh import MeshConfig as JMeshConfig
from determined_tpu.parallel.mesh import create_mesh as jcreate_mesh
from determined_tpu.train import JaxTrial
from determined_tpu.train import Trainer as JTrainer
from determined_tpu.train.trial import TrialContext as JTrialContext
from determined_tpu_torch.parallel import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
DIMS = dict(vocab_size=65, n_positions=32, d_model=32, n_layer=2, n_head=4)
GLOBAL_BATCH, SEQ, STEPS, LR = 8, 17, 4, 1e-3
MODEL_CASES = {  # name: (mesh, attention_impl)
    "data2_tensor2": ({"data": 2, "tensor": 2}, "flash"),
    "fsdp2_tensor2": ({"data": 1, "fsdp": 2, "tensor": 2}, "flash"),
    "context2_tensor2_ring": ({"data": 1, "context": 2, "tensor": 2},
                              "ring"),
    "context2_tensor2_ulysses": ({"data": 1, "context": 2, "tensor": 2},
                                 "ulysses"),
}
FIT_MESH = {"data": 1, "context": 2, "tensor": 2}
FIT_CASES = {  # name: (attention_impl, vocab_size)
    "ring": ("ring", 64), "ulysses": ("ulysses", 64),
    "ring_uneven": ("ring", 65)}
TIMEOUT_S = 150

WORKER = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from determined_tpu_torch import core
from determined_tpu_torch.core._distributed import DistributedContext
from determined_tpu_torch.models import gpt2
from determined_tpu_torch.parallel import sharding
from determined_tpu_torch.parallel.mesh import (
    MeshConfig, axis_group, batch_shard, create_mesh)
from determined_tpu_torch.train import TorchTrial, Trainer, optim
from determined_tpu_torch.train import state as state_mod
from determined_tpu_torch.train.step import global_mean
from determined_tpu_torch.train.trial import TrialContext

rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
DIMS, CASES, FIT_MESH, FIT_CASES = (json.loads(a) for a in sys.argv[4:8])
GLOBAL_BATCH, STEPS, LR = 8, 4, 1e-3
with np.load(os.path.join(out, "params.npz")) as f:
    FLAT = {k: f[k] for k in f.files}
with np.load(os.path.join(out, "batches.npz")) as f:
    TOKENS = f["tokens"]


def params(device=None, vocab=None):
    flat = dict(FLAT)
    flat["wte"] = flat["wte"][:vocab]
    return gpt2.params_from_numpy(gpt2._unflatten(flat), device)


dist_ctx = DistributedContext.from_allocation(
    "file://" + os.path.join(out, "store"), world, rank, backend="gloo")
report = {"cases": {}}

# The model over each mesh.
for name, (sizes, impl) in CASES.items():
    cfg = gpt2.Config(**DIMS, dtype=torch.float32, attention_impl=impl)
    mc = MeshConfig(**sizes)
    mesh = create_mesh(mc, "cpu")
    state = state_mod.create_train_state(
        lambda g: params(), optim.adamw(LR), torch.Generator(), mesh=mesh,
        param_logical_axes=gpt2.param_logical_axes(cfg))
    i, n = batch_shard(mc, rank, world)
    rows = torch.from_numpy(TOKENS[0][i * GLOBAL_BATCH // n:
                                      (i + 1) * GLOBAL_BATCH // n])
    loss = gpt2.loss_fn(state.params, {"tokens": rows}, cfg)
    grads = torch.autograd.grad(loss, state.leaves())
    full = state_mod.full_leaves(state, list(grads))
    with torch.no_grad():
        logits = gpt2.apply(state.params, rows[:, :-1], cfg)
    (loss,) = global_mean([loss])
    # The layout round trip, and this rank's qkv columns: its heads' q,
    # then k, then v (rows: its fsdp piece of "embed").
    back = state_mod.full_leaves(state)
    same = all(torch.equal(a, b) for a, b in zip(
        back, state_mod.param_leaves(params())))
    tensor = axis_group(mesh, "tensor")
    fsdp = axis_group(mesh, "fsdp")
    d = DIMS["d_model"]
    w = torch.from_numpy(FLAT["blocks/qkv/kernel"])
    if fsdp is not None:
        w = w.chunk(fsdp.size, dim=1)[fsdp.index]
    cols = d // tensor.size
    want = torch.cat([w[..., p * d + tensor.index * cols:
                        p * d + (tensor.index + 1) * cols]
                      for p in range(3)], dim=-1)
    local = sharding.local_value(state.params["blocks"]["qkv"]["kernel"])
    np.savez(os.path.join(out, f"{name}.rank{rank}.npz"),
             logits=logits.numpy(), loss=loss.numpy(),
             **{k: g.numpy() for k, g in zip(gpt2._flatten(params()), full)})
    report["cases"][name] = {"rows": [i, n], "round_trip": same,
                             "qkv_heads": bool(torch.equal(local, want))}
    # What the model refuses over this mesh: plain attention over a
    # context axis, and (as JAX does) MoE blocks under pipeline; an MoE
    # config over tensor and context is trained in
    # tests/test_torch_moe_axes.py.
    refused = []
    for bad, fn in ((dict(attention_impl="flash"), gpt2.loss_fn),
                    (dict(num_experts=4), lambda p, b, c: (
                        gpt2.loss_fn_pipelined(p, b, c, mesh)))):
        try:
            fn(state.params, {"tokens": rows},
               gpt2.Config(**{**cfg.__dict__, **bad}))
            refused.append(None)
        except (ValueError, NotImplementedError) as e:
            refused.append(str(e))
    report["cases"][name]["refused"] = refused
    del state, grads

# The Trainer at FIT_MESH, ring then Ulysses.


def trial_class(impl, vocab):
    class Trial(TorchTrial):
        def __init__(self, context):
            super().__init__(context)
            self.cfg = gpt2.Config(**{**DIMS, "vocab_size": vocab},
                                   dtype=torch.float32, attention_impl=impl)

        def init_params(self, rng):
            return params(rng.device, vocab)

        def loss(self, p, batch, rng):
            return gpt2.loss_fn(p, batch, self.cfg)

        def param_logical_axes(self):
            return gpt2.param_logical_axes(self.cfg)

        def optimizer(self):
            sched = optim.warmup_cosine_decay_schedule(0.0, LR, 1, 100)
            return optim.chain(optim.clip_by_global_norm(1.0),
                               optim.adamw(sched, b2=0.95, weight_decay=0.1))

        def build_training_data(self):
            d = self.context.distributed
            i, n = batch_shard(self.mesh_config(), d.rank, d.size)
            rows = GLOBAL_BATCH // n
            for t in TOKENS:
                yield {"tokens": t[i * rows:(i + 1) * rows] % vocab}

    return Trial


contexts = []  # closed at the end: a close takes the process group down
for name, (impl, vocab) in FIT_CASES.items():
    ctx = core.init(max_length=STEPS, distributed=dist_ctx,
                    checkpoint_dir=os.path.join(out, f"ckpt_{name}"))
    trial = trial_class(impl, vocab)(TrialContext(
        hparams={"mesh": FIT_MESH}, core_context=ctx,
        global_batch_size=GLOBAL_BATCH))
    trainer = Trainer(trial, core_context=ctx, device="cpu")
    state = trainer.fit(report_period=1)
    full = state_mod.unshard_state(state)
    if rank == 0:
        np.savez(os.path.join(out, f"fit_{name}.npz"),
                 **gpt2._flatten(gpt2.params_to_numpy(full.params)))
        report[f"fit_{name}"] = {
            "metrics": [r["metrics"] for r in
                        ctx.train.local_training_metrics],
            "checkpoints": [r["uuid"] for r in
                            ctx.checkpoint.local_reported],
            "mesh": dict(zip(trainer.mesh.mesh_dim_names,
                             trainer.mesh.mesh.shape))}
    ctx.checkpoint.wait()
    contexts.append(ctx)
with open(os.path.join(out, f"report{rank}.json"), "w") as f:
    json.dump(report, f)
for ctx in contexts:
    ctx.close()
'''


def numpy_params(seed=0, std=0.2):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda r: jgpt2.init(r, jax_config()),
                            jax.random.PRNGKey(0))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        k = "/".join(str(getattr(p, "key", p)) for p in path)
        base = 1.0 if k.endswith("scale") else 0.0
        out[k] = (base + std * rng.normal(size=leaf.shape)).astype(np.float32)
    return out


def jax_config(impl="flash", vocab=DIMS["vocab_size"]):
    return jgpt2.Config(**{**DIMS, "vocab_size": vocab}, dtype=jnp.float32,
                        attention_impl=impl)


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


@pytest.fixture(scope="module")
def inputs():
    params = numpy_params()
    tokens = np.random.default_rng(1).integers(
        0, DIMS["vocab_size"], size=(STEPS, GLOBAL_BATCH, SEQ)
    ).astype(np.int32)
    return params, tokens


def run_world(tmp_path_factory, inputs, devices, model_cases, fit_cases):
    """`model_cases` and `fit_cases` in one world of 4, and the JAX side
    computed while it runs -> (the ranks' reports, the run dir, the JAX
    results)."""
    params, tokens = inputs
    out = tmp_path_factory.mktemp("tensor_world")
    np.savez(out / "params.npz", **params)
    np.savez(out / "batches.npz", tokens=tokens)
    script = out / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    args = [json.dumps(a) for a in (DIMS, model_cases, FIT_MESH, fit_cases)]
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(WORLD), str(out), *args],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    logs = []
    try:
        ref = jax_side(inputs, devices, tmp_path_factory.mktemp("jax"),
                       model_cases, fit_cases)
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


@pytest.fixture(scope="module")
def world(tmp_path_factory, inputs, devices):
    """The model cases in one world of 4 (the fits run in
    test_torch_tensor_parallel_fit.py's)."""
    return run_world(tmp_path_factory, inputs, devices, MODEL_CASES, {})


def jax_side(inputs, devices, tmp, model_cases, fit_cases):
    """JAX's logits, loss and gradients for each model case on its mesh,
    and the JAX Trainer's runs of the fit cases it can lay out (ring and
    Ulysses)."""
    params, tokens = inputs
    batch = {"tokens": jnp.asarray(tokens[0])}
    jparams = jax.tree_util.tree_map(jnp.asarray, unflatten(params))
    ref = {}
    for name, (sizes, impl) in model_cases.items():
        cfg = jax_config(impl)
        mesh = jax_mesh(sizes, devices)
        with jax.sharding.set_mesh(mesh):
            loss, grads, logits = jax.jit(lambda p: (*jax.value_and_grad(
                lambda q: jgpt2.loss_fn(q, batch, cfg))(p),
                jgpt2.apply(p, batch["tokens"][:, :-1], cfg)))(jparams)
        ref[name] = (float(loss), flatten(grads), np.asarray(logits))
    for name in ("ring", "ulysses"):
        if name in fit_cases:
            ref[f"fit_{name}"] = run_jax(tmp / name, inputs,
                                         *fit_cases[name])
    return ref


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_model_matches_jax(world, name):
    reports, out, ref = world
    loss, grads, logits = ref[name]
    ranks = [dict(np.load(out / f"{name}.rank{r}.npz")) for r in range(WORLD)]
    got = np.zeros(np.shape(logits), np.float32)
    for r in range(WORLD):
        i, n = reports[r]["cases"][name]["rows"]
        got[i * GLOBAL_BATCH // n:(i + 1) * GLOBAL_BATCH // n] = \
            ranks[r]["logits"]
    np.testing.assert_allclose(got, logits, atol=2e-5,
                               err_msg=f"{name} logits")
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r]["loss"], loss, rtol=1e-5,
                                   err_msg=f"{name} loss, rank {r}")
    for k, want in grads.items():
        scale = np.abs(want).max()
        for r in range(WORLD):
            err = np.abs(ranks[r][k] - want).max()
            assert err <= 1e-5 * scale, (name, k, r, err, scale)


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_tensor_layout(world, name):
    reports = world[0]
    for r, rep in enumerate(reports):
        case = rep["cases"][name]
        assert case["round_trip"], (name, r)
        assert case["qkv_heads"], (name, r)


def test_the_model_refuses_what_it_cannot_split(world):
    reports = world[0]
    for name, (sizes, impl) in MODEL_CASES.items():
        for rep in reports:
            flash, moe = rep["cases"][name]["refused"]
            if sizes.get("context", 1) > 1:
                assert "use attention_impl ring or ulysses" in flash, name
            else:
                assert flash is None, name
            assert "not supported under pipeline parallelism" in moe, name


class JaxGPT2(JaxTrial):
    def __init__(self, context, impl, vocab, params, tokens):
        super().__init__(context)
        self.cfg = jax_config(impl, vocab)
        self.params = {**params, "wte": params["wte"][:vocab]}
        self.tokens = tokens % vocab

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


def run_jax(tmp, inputs, impl, vocab):
    params, tokens = inputs
    ctx = jcore.init(max_length=STEPS, checkpoint_dir=str(tmp))
    trainer = JTrainer(JaxGPT2(JTrialContext(hparams={"mesh": FIT_MESH},
                                             core_context=ctx),
                               impl, vocab, params, tokens),
                       core_context=ctx, devices=jax.devices()[:WORLD])
    state = trainer.fit(report_period=1)
    metrics = [r["metrics"] for r in ctx.train.local_training_metrics]
    ctx.close()
    return metrics, flatten(state.params), dict(trainer.mesh.shape)


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


def assert_metrics(got, want, what):
    assert len(got) == len(want) == STEPS, what
    for g, w in zip(got, want):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5,
                                       err_msg=f"{what} {key}")


def port_trial_class(params, tokens, vocab):
    from determined_tpu_torch.models import gpt2 as tgpt2
    from determined_tpu_torch.train import TorchTrial, optim

    class Trial(TorchTrial):
        cfg = tgpt2.Config(**{**DIMS, "vocab_size": vocab},
                           dtype=torch.float32)

        def init_params(self, rng):
            return tgpt2.params_from_numpy(
                unflatten({**params, "wte": params["wte"][:vocab]}),
                rng.device)

        def loss(self, p, batch, rng):
            return tgpt2.loss_fn(p, batch, self.cfg)

        def optimizer(self):
            sched = optim.warmup_cosine_decay_schedule(0.0, LR, 1, 100)
            return optim.chain(optim.clip_by_global_norm(1.0),
                               optim.adamw(sched, b2=0.95, weight_decay=0.1))

        def build_training_data(self):
            return [{"tokens": t % vocab} for t in tokens]

    return Trial


def test_seq_shard_orders_chunks_by_context_rank():
    cfg = tmesh.MeshConfig(data=2, context=2, tensor=2)
    seen = {}
    for rank in range(8):
        start, stop = tmesh.seq_shard(cfg, rank, 8, 16)
        coord = (rank // 2) % 2  # the context coordinate, AXIS_ORDER
        seen.setdefault(coord, set()).add((start, stop))
    assert seen == {0: {(0, 8)}, 1: {(8, 16)}}
    with pytest.raises(ValueError, match="equal chunks"):
        tmesh.seq_shard(cfg, 0, 8, 15)
    assert tmesh.axis_group(None, "context") is None
