"""The port's Trainer over an `expert` mesh axis against the JAX Trainer,
on the CPU.

A tiny fp32 MoE GPT-2 trial (4 experts, top-2, capacity factor 1.25)
with numpy-drawn params trains 4 steps at a global batch of 8 rows
through `determined_tpu_torch.train.Trainer` in 4 processes with
`fsdp=2, expert=2` (a gloo process group over a FileStore in the test's
directory, one worker process per rank; each rank's loader yields its
block of the batch by `parallel.mesh.batch_shard`, so the two ranks of
an expert group hold the same rows), in one process, and through the
JAX Trainer on 4 of the 8 virtual CPU devices with the same mesh and
the same global batches. Each rank holds 2 of the 4 experts, split over
fsdp along "embed"; routing is global (the counts' prefix over the
batch group, capacity from the global token count). The losses and grad
norms each step reports and the final params must agree; the run's
checkpoint (written by the chief in the one-process format) restores
into a one-process Trainer and into a serve replica.

Tolerances as tests/test_torch_fsdp_trainer.py: losses and grad norms
rtol 1e-5; params atol 1e-5 except the key bias (its gradient is 0 in
exact arithmetic, so Adam turns fp32 noise into steps of about lr), held
to 2 x lr x steps.
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
DIMS = dict(vocab_size=64, n_positions=32, d_model=32, n_layer=2, n_head=2,
            num_experts=4, moe_top_k=2)
MESH = {"data": 1, "fsdp": 2, "expert": 2}
WORLD = 4
GLOBAL_BATCH, SEQ, STEPS, LR = 8, 17, 4, 1e-3
TIMEOUT_S = 120

# One rank of the port's run: `python worker.py RANK WORLD MESH DIR DIMS`.
# Imports only the port.
WORKER = r'''
import json, os, sys
import numpy as np
import torch
from determined_tpu_torch import core
from determined_tpu_torch.core._distributed import DistributedContext
from determined_tpu_torch.models import gpt2
from determined_tpu_torch.parallel.mesh import batch_shard
from determined_tpu_torch.train import TorchTrial, Trainer, optim
from determined_tpu_torch.train import state as state_mod
from determined_tpu_torch.train.trial import TrialContext

rank, world, mesh, out = (int(sys.argv[1]), int(sys.argv[2]),
                          json.loads(sys.argv[3]), sys.argv[4])
DIMS = json.loads(sys.argv[5])
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
        with np.load(os.path.join(out, "batches.npz")) as f:
            tokens = f["tokens"]
        for t in tokens:
            yield {"tokens": t[i * rows:(i + 1) * rows]}


dist = DistributedContext.from_allocation(
    "file://" + os.path.join(out, "store"), world, rank, backend="gloo")
ctx = core.init(max_length=STEPS, checkpoint_dir=os.path.join(out, "ckpt"),
                distributed=dist)
trial = Trial(TrialContext(hparams={"mesh": mesh}, core_context=ctx,
                           global_batch_size=GLOBAL_BATCH))
trainer = Trainer(trial, core_context=ctx, device="cpu")
state = trainer.fit(report_period=1)
from torch.distributed.tensor import DTensor
up = state.params["blocks"]["moe"]["up"]["kernel"]
local = tuple(up._local_tensor.shape) if isinstance(up, DTensor) else None
full = state_mod.unshard_state(state)
if rank == 0:
    np.savez(os.path.join(out, "final.npz"),
             **gpt2._flatten(gpt2.params_to_numpy(full.params)))
    with open(os.path.join(out, "report.json"), "w") as f:
        json.dump({"metrics": [r["metrics"] for r in
                               ctx.train.local_training_metrics],
                   "checkpoints": [r["uuid"] for r in
                                   ctx.checkpoint.local_reported],
                   "expert_local_shape": local,
                   "mesh": list(trainer.mesh.mesh.shape)}, f)
ctx.close()
'''


def jax_config():
    return jgpt2.Config(**DIMS, dtype=jnp.float32)


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


def unflatten(flat):
    tree = {}
    for path, val in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_inputs")
    params = numpy_params()
    tokens = np.random.default_rng(1).integers(
        0, DIMS["vocab_size"], size=(STEPS, GLOBAL_BATCH, SEQ)
    ).astype(np.int32)
    np.savez(d / "params.npz", **params)
    np.savez(d / "batches.npz", tokens=tokens)
    return d, params, tokens


@pytest.fixture(scope="module")
def world4(tmp_path_factory, inputs):
    """The port's fit over 4 worker processes -> (report, final params,
    run dir): shared by the tests that read it."""
    src, _, _ = inputs
    out = tmp_path_factory.mktemp("moe_world4")
    for name in ("params.npz", "batches.npz"):
        shutil.copy(src / name, out / name)
    script = out / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(WORLD), json.dumps(MESH),
         str(out), json.dumps(DIMS)], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
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


class JaxMoE(JaxTrial):
    def __init__(self, context, params, tokens):
        super().__init__(context)
        self.cfg = jax_config()
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


def run_jax(tmp_path, inputs):
    _, params, tokens = inputs
    ctx = jcore.init(max_length=STEPS, checkpoint_dir=str(tmp_path / "jax"))
    trainer = JTrainer(JaxMoE(JTrialContext(hparams={"mesh": MESH},
                                            core_context=ctx),
                              params, tokens),
                       core_context=ctx, devices=jax.devices()[:WORLD])
    state = trainer.fit(report_period=1)
    metrics = [r["metrics"] for r in ctx.train.local_training_metrics]
    flat = {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(state.params)[0]}
    ctx.close()
    return metrics, flat, dict(trainer.mesh.shape)


def port_trial_class(params, tokens):
    from determined_tpu_torch.models import gpt2 as tgpt2
    from determined_tpu_torch.train import TorchTrial, optim

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

    return Trial


def port_one_process(tmp_path, inputs):
    from determined_tpu_torch import core as tcore
    from determined_tpu_torch.models import gpt2 as tgpt2
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train.trial import TrialContext

    _, params, tokens = inputs
    Trial = port_trial_class(params, tokens)
    ctx = tcore.init(max_length=STEPS, checkpoint_dir=str(tmp_path / "one"))
    state = Trainer(Trial(TrialContext(core_context=ctx)), core_context=ctx,
                    device="cpu").fit(report_period=1)
    metrics = [r["metrics"] for r in ctx.train.local_training_metrics]
    final = tgpt2._flatten(tgpt2.params_to_numpy(state.params))
    ctx.close()
    return metrics, final


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


def test_fit_over_the_expert_axis_matches_jax_and_one_process(
        tmp_path, inputs, world4):
    report, final, _ = world4
    e, d, f = DIMS["num_experts"], DIMS["d_model"], 4 * DIMS["d_model"]
    # Each rank: 2 of the 4 experts, half of "embed".
    assert report["expert_local_shape"] == [DIMS["n_layer"], e // 2, d // 2,
                                            f]
    assert report["mesh"] == [1, 1, 2, 2, 1, 1]
    jmetrics, jfinal, jmesh = run_jax(tmp_path, inputs)
    assert (jmesh["fsdp"], jmesh["expert"]) == (2, 2)
    assert_metrics(report["metrics"], jmetrics, "world 4 vs JAX")
    assert_params(final, jfinal, "world 4 vs JAX")
    one_metrics, one_final = port_one_process(tmp_path, inputs)
    assert_metrics(report["metrics"], one_metrics, "world 4 vs one process")
    assert_params(final, one_final, "world 4 vs one process")
    assert report["checkpoints"] == [f"trial0-step{STEPS}"]


def test_the_checkpoint_restores_into_one_process_and_a_replica(
        tmp_path, inputs, world4):
    from determined_tpu_torch import core as tcore
    from determined_tpu_torch.models import gpt2 as tgpt2
    from determined_tpu_torch.serve.engine import ServingEngine
    from determined_tpu_torch.serve.task import build_replica
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train.trial import TrialContext

    report, final, out = world4
    (sid,) = report["checkpoints"]
    _, params, tokens = inputs
    # A copy: the restoring run must not add to the shared run's storage.
    shutil.copytree(out / "ckpt", tmp_path / "ckpt")
    ctx = tcore.init(max_length=STEPS, checkpoint_dir=str(tmp_path / "ckpt"))
    Trial = port_trial_class(params, tokens)
    state = Trainer(Trial(TrialContext(core_context=ctx)), core_context=ctx,
                    device="cpu").fit(resume_from=sid)  # at max_length
    ctx.close()
    assert state.step == STEPS
    restored = tgpt2._flatten(tgpt2.params_to_numpy(state.params))
    for k, v in final.items():
        np.testing.assert_array_equal(restored[k], v, err_msg=k)

    serving = {"model_config": {"model_size": "tiny", "dtype": "float32",
                                **DIMS}, "checkpoint": sid,
               "max_batch_size": 2, "max_seq_len": 32, "kv_block_size": 8,
               "prefill_buckets": [8, 16], "device": "cpu"}
    engine, _ = build_replica({"serving": serving, "checkpoint_storage": {
        "type": "shared_fs", "host_path": str(tmp_path / "ckpt")}})
    for k, v in tgpt2._flatten(engine.params).items():
        np.testing.assert_array_equal(v.numpy(), final[k], err_msg=k)
    direct = ServingEngine(tgpt2.params_from_numpy(unflatten(final)),
                           engine.cfg, slots=2, max_seq_len=32,
                           prefill_buckets=[8, 16], kv_block_size=8,
                           device="cpu")
    prompt = tokens[0, 0, :11]
    got = engine.prefill_logits(0, prompt)
    np.testing.assert_array_equal(got.numpy(),
                                  direct.prefill_logits(0, prompt).numpy())
    assert torch.isfinite(got).all()
