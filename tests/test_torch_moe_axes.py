"""MoE GPT-2 over the `tensor` and `context` mesh axes: the port against
the JAX package, on the CPU.

One world of 4 gloo processes (a worker per rank over a FileStore in the
test's directory; the worker imports only the port) runs every case:

  - the model: a TINY fp32 MoE GPT-2 (4 experts, top-2, capacity factor
    1.25, numpy-drawn params) laid out by `create_train_state` at context
    2 x tensor 2, data 2 x context 2, expert 2 x tensor 2 and expert 2 x
    context 2 (ring attention over context). Its logits (`gpt2.apply`),
    loss with the load-balance term and every gradient (`gpt2.loss_fn`,
    gathered into the one-process layout) against
    `determined_tpu.models.gpt2` and `jax.grad` on the same mesh (4 of the
    8 virtual CPU devices), where GSPMD routes over the global token
    order. Each rank records its router probabilities, and every case
    first asserts tests/test_torch_moe.py's routing margin: a gap of at
    least 1e-4 between each token's first k + 1 sorted probabilities, so
    a routing mismatch is a fault, not a near-tie.
  - the Trainer: `fit` 4 steps at expert 2 x context 2 against the JAX
    Trainer with the same trial, mesh and batches.

In this process: `ops.moe.route` walked over 2 and 4 context chunks of
each row, each chunk fed the per-row counts the group's gather would
deliver, against one `route` over the whole (bitwise, as chip_smoke.py's
16c checks at full width).

Tolerances, those of tests/test_torch_tensor_parallel.py: logits atol
2e-5, gradients 1e-5 of each leaf's largest element, losses and grad
norms rtol 1e-5, params atol 1e-5 but the key bias (2 x lr x steps).
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
from determined_tpu_torch.ops import moe as tmoe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
DIMS = dict(vocab_size=64, n_positions=32, d_model=32, n_layer=2, n_head=4,
            num_experts=4, moe_top_k=2)
GLOBAL_BATCH, SEQ, STEPS, LR = 8, 17, 4, 1e-3
MARGIN = 1e-4
MODEL_CASES = {  # name: (mesh, attention_impl)
    "context2_tensor2": ({"data": 1, "context": 2, "tensor": 2}, "ring"),
    "data2_context2": ({"data": 2, "context": 2}, "ring"),
    "expert2_tensor2": ({"data": 1, "expert": 2, "tensor": 2}, "flash"),
    "expert2_context2": ({"data": 1, "expert": 2, "context": 2}, "ring"),
}
FIT_MESH = {"data": 1, "expert": 2, "context": 2}
TIMEOUT_S = 150

WORKER = r'''
import json, os, sys
import numpy as np
import torch
from determined_tpu_torch import core
from determined_tpu_torch.core._distributed import DistributedContext
from determined_tpu_torch.models import gpt2
from determined_tpu_torch.ops import moe
from determined_tpu_torch.parallel.mesh import (
    MeshConfig, batch_shard, create_mesh)
from determined_tpu_torch.train import TorchTrial, Trainer, optim
from determined_tpu_torch.train import state as state_mod
from determined_tpu_torch.train.step import global_mean
from determined_tpu_torch.train.trial import TrialContext

rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
DIMS, CASES, FIT_MESH = (json.loads(a) for a in sys.argv[4:7])
GLOBAL_BATCH, STEPS, LR = 8, 4, 1e-3
with np.load(os.path.join(out, "params.npz")) as f:
    FLAT = {k: f[k] for k in f.files}
with np.load(os.path.join(out, "batches.npz")) as f:
    TOKENS = f["tokens"]
dist_ctx = DistributedContext.from_allocation(
    "file://" + os.path.join(out, "store"), world, rank, backend="gloo")
report = {"cases": {}}

# Every route's smallest gap between a token's first k + 1 probabilities.
gaps = []
route = moe.route


def recording(*args, **kwargs):
    r = route(*args, **kwargs)
    top = torch.sort(r.probs.detach(), dim=-1, descending=True).values
    n = min(r.gate_idx.shape[1], top.shape[1] - 1)
    gaps.append(float((top[:, :n] - top[:, 1:n + 1]).min()))
    return r


moe.route = recording


def params(device=None):
    return gpt2.params_from_numpy(gpt2._unflatten(dict(FLAT)), device)


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
    gaps.clear()
    loss = gpt2.loss_fn(state.params, {"tokens": rows}, cfg)
    grads = torch.autograd.grad(loss, state.leaves())
    full = state_mod.full_leaves(state, list(grads))
    with torch.no_grad():
        logits = gpt2.apply(state.params, rows[:, :-1], cfg)
    (loss,) = global_mean([loss])
    np.savez(os.path.join(out, f"{name}.rank{rank}.npz"),
             logits=logits.numpy(), loss=loss.numpy(),
             **{k: g.numpy() for k, g in zip(gpt2._flatten(params()), full)})
    report["cases"][name] = {"rows": [i, n], "margin": min(gaps)}
    del state, grads


class Trial(TorchTrial):
    def __init__(self, context):
        super().__init__(context)
        self.cfg = gpt2.Config(**DIMS, dtype=torch.float32,
                               attention_impl="ring")

    def init_params(self, rng):
        return params(rng.device)

    def loss(self, p, batch, rng):
        return gpt2.loss_fn(p, batch, self.cfg)

    def param_logical_axes(self):
        return gpt2.param_logical_axes(self.cfg)

    def supports_expert_parallel(self):
        return True

    def optimizer(self):
        sched = optim.warmup_cosine_decay_schedule(0.0, LR, 1, 100)
        return optim.chain(optim.clip_by_global_norm(1.0),
                           optim.adamw(sched, b2=0.95, weight_decay=0.1))

    def build_training_data(self):
        d = self.context.distributed
        i, n = batch_shard(self.mesh_config(), d.rank, d.size)
        rows = GLOBAL_BATCH // n
        for t in TOKENS:
            yield {"tokens": t[i * rows:(i + 1) * rows]}


gaps.clear()
ctx = core.init(max_length=STEPS, distributed=dist_ctx,
                checkpoint_dir=os.path.join(out, "ckpt"))
trainer = Trainer(Trial(TrialContext(
    hparams={"mesh": FIT_MESH}, core_context=ctx,
    global_batch_size=GLOBAL_BATCH)), core_context=ctx, device="cpu")
state = trainer.fit(report_period=1)
full = state_mod.unshard_state(state)
if rank == 0:
    np.savez(os.path.join(out, "fit.npz"),
             **gpt2._flatten(gpt2.params_to_numpy(full.params)))
    report["fit"] = {
        "metrics": [r["metrics"] for r in ctx.train.local_training_metrics],
        "margin": min(gaps),
        "mesh": dict(zip(trainer.mesh.mesh_dim_names,
                         trainer.mesh.mesh.shape))}
ctx.checkpoint.wait()
with open(os.path.join(out, f"report{rank}.json"), "w") as f:
    json.dump(report, f)
ctx.close()
'''


def jax_config(impl="flash"):
    return jgpt2.Config(**DIMS, dtype=jnp.float32, attention_impl=impl)


def numpy_params(seed=0, std=0.3):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda r: jgpt2.init(r, jax_config()),
                            jax.random.PRNGKey(0))
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


@pytest.fixture(scope="module")
def inputs():
    tokens = np.random.default_rng(1).integers(
        0, DIMS["vocab_size"], size=(STEPS, GLOBAL_BATCH, SEQ)
    ).astype(np.int32)
    return numpy_params(), tokens


def start_world(out, inputs):
    """The world's 4 worker processes, started on the inputs in `out`."""
    params, tokens = inputs
    np.savez(out / "params.npz", **params)
    np.savez(out / "batches.npz", tokens=tokens)
    script = out / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    args = [json.dumps(a) for a in (DIMS, MODEL_CASES, FIT_MESH)]
    return [subprocess.Popen(
        [sys.executable, str(script), str(r), str(WORLD), str(out), *args],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]


@pytest.fixture(scope="module")
def world(tmp_path_factory, inputs, devices):
    """Every case in one world of 4, and the JAX side computed while it
    runs -> (the ranks' reports, the run dir, the JAX results)."""
    out = tmp_path_factory.mktemp("moe_axes_world")
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
    """JAX's logits, loss and gradients for each case on its mesh, and
    the JAX Trainer's run at FIT_MESH."""
    params, tokens = inputs
    batch = {"tokens": jnp.asarray(tokens[0])}
    jparams = jax.tree_util.tree_map(jnp.asarray, unflatten(params))
    ref = {}
    for name, (sizes, impl) in MODEL_CASES.items():
        cfg = jax_config(impl)
        mesh = jcreate_mesh(JMeshConfig(**sizes).resolve(WORLD),
                            devices[:WORLD])
        with jax.sharding.set_mesh(mesh):
            loss, grads, logits = jax.jit(lambda p: (*jax.value_and_grad(
                lambda q: jgpt2.loss_fn(q, batch, cfg))(p),
                jgpt2.apply(p, batch["tokens"][:, :-1], cfg)))(jparams)
        ref[name] = (float(loss), flatten(grads), np.asarray(logits))
    ctx = jcore.init(max_length=STEPS, checkpoint_dir=str(tmp / "ckpt"))
    trainer = JTrainer(JaxMoE(JTrialContext(hparams={"mesh": FIT_MESH},
                                            core_context=ctx),
                              params, tokens),
                       core_context=ctx, devices=jax.devices()[:WORLD])
    state = trainer.fit(report_period=1)
    ref["fit"] = {
        "metrics": [r["metrics"] for r in ctx.train.local_training_metrics],
        "final": flatten(state.params), "mesh": dict(trainer.mesh.shape)}
    ctx.close()
    return ref


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_moe_model_matches_jax(world, name):
    reports, out, ref = world
    for r in range(WORLD):
        assert reports[r]["cases"][name]["margin"] >= MARGIN, (name, r)
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


class JaxMoE(JaxTrial):
    def __init__(self, context, params, tokens):
        super().__init__(context)
        self.cfg = jax_config("ring")
        self.params, self.tokens = params, tokens

    def init_params(self, rng):
        return jax.tree_util.tree_map(jnp.asarray, unflatten(self.params))

    def loss(self, params, batch, rng):
        return jgpt2.loss_fn(params, batch, self.cfg)

    def param_logical_axes(self):
        return jgpt2.param_logical_axes(self.cfg)

    def supports_expert_parallel(self):
        return True

    def optimizer(self):
        sched = optax.warmup_cosine_decay_schedule(0.0, LR, 1, 100)
        return optax.chain(optax.clip_by_global_norm(1.0),
                           optax.adamw(sched, b2=0.95, weight_decay=0.1))

    def build_training_data(self):
        return [{"tokens": t} for t in self.tokens]


def test_fit_matches_the_jax_trainer(world):
    reports, out, ref = world
    run, jrun = reports[0]["fit"], ref["fit"]
    assert run["margin"] >= MARGIN
    for axis in ("expert", "context"):
        assert run["mesh"][axis] == jrun["mesh"][axis] == 2
    assert len(run["metrics"]) == len(jrun["metrics"]) == STEPS
    for g, w in zip(run["metrics"], jrun["metrics"]):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5,
                                       err_msg=key)
    got = dict(np.load(out / "fit.npz"))
    assert set(got) == set(jrun["final"])
    d = DIMS["d_model"]
    for k, w in jrun["final"].items():
        g = got[k]
        if k == "blocks/qkv/bias":
            # The key third: Adam's steps on fp32 noise (module docstring).
            np.testing.assert_allclose(g[:, d:2 * d], w[:, d:2 * d],
                                       atol=2 * LR * STEPS)
            g, w = np.delete(g, np.s_[d:2 * d], 1), \
                np.delete(w, np.s_[d:2 * d], 1)
        np.testing.assert_allclose(g, w, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("chunks", [2, 4])
def test_routing_walked_over_context_chunks_is_one_route(chunks):
    """Each chunk of each row routed as a context rank routes it, fed the
    per-row counts of every chunk (what the group's all-gather delivers),
    takes exactly the slots one route over the whole batch gives it."""
    rng = np.random.default_rng(chunks)
    e, k, cf, b, s, d = 8, 2, 1.25, 3, 16, 8
    x = torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32))
    router = torch.from_numpy(rng.normal(size=(d, e)).astype(np.float32))
    whole = tmoe.route(x.reshape(-1, d), router, e, k, cf, rows=b)
    assert not whole.kept.all()  # some drops, so the order matters
    parts = list(x.chunk(chunks, dim=1))
    alone = [tmoe.route(p.reshape(-1, d), router, e, k, cf, rows=b)
             for p in parts]
    counts = torch.stack([tmoe.row_counts(r.gate_idx, e, b)
                          for r in alone])[None]
    walked = [tmoe.route(p.reshape(-1, d), router, e, k, cf,
                         tmoe.chunk_place(j, chunks), rows=b, counts=counts)
              for j, p in enumerate(parts)]

    def merged(field):  # the chunks' [b * s / c, ...] back in token order
        return torch.cat([getattr(r, field).reshape(b, s // chunks, -1)
                          for r in walked], dim=1).reshape(b * s, -1)

    for field in ("pos", "kept", "gate_idx", "gate_vals", "probs"):
        assert torch.equal(merged(field), getattr(whole, field)), field
    assert {r.capacity for r in walked} == {whole.capacity}
    aux_walked = tmoe._aux_loss(tmoe.Routing(
        merged("probs"), merged("gate_idx"), merged("gate_vals"),
        merged("pos"), merged("kept"), whole.capacity), e, None)
    aux_whole = tmoe._aux_loss(whole, e, None)
    np.testing.assert_allclose(float(aux_walked), float(aux_whole),
                               rtol=1e-6)
    # A chunk that ignores the earlier chunks' counts routes apart.
    wrong = tmoe.route(parts[-1].reshape(-1, d), router, e, k, cf,
                       tmoe.chunk_place(0, chunks), rows=b, counts=counts)
    assert not torch.equal(wrong.pos, walked[-1].pos)
