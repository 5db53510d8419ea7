"""`Trainer.fit`'s captured step over a mesh of several processes, on the CPU.

Over a CUDA mesh `fit` runs `make_captured_step` with the mesh: each rank
captures its sharded step with its collectives, and every call is agreed
on first over the mesh's gloo control group (`step._agree`). On the CPU
the same step object runs its plain version with the same vote. One gloo
world of 2 processes (a FileStore in the test's directory, one worker
process per rank) runs every case; the JAX side runs while it does.

  - Parity at `fsdp: 2` and at `tensor: 2`: a tiny fp32 GPT-2 with
    numpy-drawn params, its 5th global batch non-finite (a flag a row the
    loss reads on the device) under `health.on_nan: rollback`, fit to
    step 8 with a checkpoint every 4, then resumed from step 8 to 10,
    against the JAX Trainer with the same mesh on 2 of the 8 virtual CPU
    devices: every report window's loss and grad norm rtol 1e-5 (a NaN
    window NaN on both sides), the params atol 1e-5, the key bias
    (gradient 0 in exact arithmetic, fp32 noise that Adam turns into
    steps of about lr) within 2 x lr x steps; `test_torch_fsdp_trainer`'s
    tolerances. The first flush names the route.
  - Every rank's state tensors keep their addresses across the rollback
    (it restores into each rank's own pieces).
  - A call that rank 1 alone refuses is refused on both ranks, before
    any step: a batch of another shape on rank 1 (both raise, naming
    every rank's shapes), and a non-tensor leaf on rank 1 (rank 1 raises
    its own error, rank 0 names rank 1); each within seconds.
  - Capture safety of the eval step at `fsdp: 2`: two consecutive calls
    of what `make_captured_eval_step` captures, under
    `test_torch_multi_step_mesh`'s detector: no host read, and the same
    sequence of collectives on both calls and both ranks.
"""

import concurrent.futures
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from determined_tpu import core as jcore
from determined_tpu.models import gpt2 as jgpt2
from determined_tpu.train import JaxTrial
from determined_tpu.train import Trainer as JTrainer
from determined_tpu.train.trial import TrialContext as JTrialContext
from test_torch_multi_step_mesh import WORKER as MESH_WORKER
from test_torch_multi_step_mesh import flatten, numpy_params, problems, \
    unflatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = dict(vocab_size=64, n_positions=32, d_model=32, n_layer=2, n_head=2)
WORLD, GLOBAL_BATCH, SEQ, LR = 2, 4, 17, 1e-3
N_BATCHES, POISON_AT = 12, 5   # batch 5 (step 5) diverges
FIRST, RESUMED = 8, 10         # fit to step 8, then resume to step 10
TIMEOUT_S = 150
PARITY = {"fsdp": {"data": 1, "fsdp": 2}, "tensor": {"data": 1, "tensor": 2}}
HEALTH = {"on_nan": "rollback", "rollback_window": 1, "max_rollbacks": 1}
# The capture-safety detector of test_torch_multi_step_mesh.py, as is.
DETECTOR = MESH_WORKER[MESH_WORKER.index("COLLECTIVE_NS = "):
                       MESH_WORKER.index("def gpt2_params(")]

# One rank: written to the test's directory and run as `python worker.py
# RANK WORLD DIR CONSTANTS_JSON`. Imports only the port.
WORKER = r'''
import json, os, sys, time
from unittest import mock
import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from determined_tpu_torch import core
from determined_tpu_torch.core._distributed import DistributedContext
from determined_tpu_torch.models import gpt2
from determined_tpu_torch.parallel.mesh import MeshConfig, batch_shard
from determined_tpu_torch.train import TorchTrial, Trainer, optim
from determined_tpu_torch.train import state as state_mod
from determined_tpu_torch.train import step as step_mod
from determined_tpu_torch.train.trial import TrialContext

rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
C = json.loads(sys.argv[4])
with np.load(os.path.join(out, "params.npz")) as f:
    FLAT = {k: f[k] for k in f.files}
with np.load(os.path.join(out, "batches.npz")) as f:
    TOKENS, POISON = f["tokens"], f["poison"]   # global batches

DETECTOR


class Trial(TorchTrial):
    health = C["health"]

    def __init__(self, context):
        super().__init__(context)
        self.cfg = gpt2.Config(**C["dims"], dtype=torch.float32)

    def init_params(self, rng):
        return gpt2.params_from_numpy(gpt2._unflatten(dict(FLAT)), rng.device)

    def loss(self, params, batch, rng):
        loss = gpt2.loss_fn(params, {"tokens": batch["tokens"]}, self.cfg)
        # No host read: the poisoned step is NaN on the device.
        return loss * torch.where((batch["poison"] > 0).any(), float("nan"),
                                  1.0)

    def evaluate(self, params, batch):
        return {"validation_loss": gpt2.loss_fn(params, batch, self.cfg)}

    def param_logical_axes(self):
        return gpt2.param_logical_axes(self.cfg)

    def optimizer(self):
        sched = optim.warmup_cosine_decay_schedule(0.0, C["lr"], 1, 100)
        return optim.chain(optim.clip_by_global_norm(1.0),
                           optim.adamw(sched, b2=0.95, weight_decay=0.1))

    def build_training_data(self):
        i, n = batch_shard(self.mesh_config().resolve(world), rank, world)
        rows = TOKENS.shape[1] // n
        for t, p in zip(TOKENS, POISON):
            yield {"tokens": t[i * rows:(i + 1) * rows],
                   "poison": p[i * rows:(i + 1) * rows]}


dist_ctx = DistributedContext.from_allocation(
    "file://" + os.path.join(out, "store"), world, rank, backend="gloo")
contexts = []   # closed at the end: close() ends the group
report = {"parity": {}, "around": {}, "refusal": {}, "eval_safety": None}
trainers = {}
for name, mesh in C["parity"].items():
    reports, around = [], []
    for length, resume in ((C["first"], None),
                           (C["resumed"], f"trial0-step{C['first']}")):
        ctx = core.init(max_length=length, distributed=dist_ctx,
                        checkpoint_dir=os.path.join(out, name))
        contexts.append(ctx)
        trainer = Trainer(Trial(TrialContext(
            hparams={"mesh": mesh}, core_context=ctx,
            global_batch_size=C["batch"])), core_context=ctx, device="cpu")
        chain = trainer._restore_chain

        def recorded(*a, _chain=chain, _t=trainer, **k):
            before = step_mod._state_ptrs(_t.state)
            got = _chain(*a, **k)
            around.append((k.get("into", False), before,
                           step_mod._state_ptrs(_t.state)))
            return got

        trainer._restore_chain = recorded
        state = trainer.fit(report_period=2, checkpoint_period=4,
                            resume_from=resume)
        assert type(trainer._train_step) is step_mod._CapturedStep
        reports += ctx.train.local_training_metrics
    full = state_mod.unshard_state(state)
    if rank == 0:
        np.savez(os.path.join(out, f"final_{name}.npz"),
                 **gpt2._flatten(gpt2.params_to_numpy(full.params)))
    report["parity"][name] = {"reports": reports, "step": state.step}
    report["around"][name] = around
    trainers[name] = trainer

# Refusals, on the fsdp trainer's captured step: rank 1 alone hands in a
# batch of another shape, then a batch with a non-tensor leaf.
trainer = trainers["fsdp"]
rng = torch.Generator().manual_seed(0)
rows = C["batch"] // 2
cases = {
    "shape": {"tokens": torch.zeros((rows + rank, C["seq"]), dtype=torch.int32),
              "poison": torch.zeros(rows + rank)},
    "leaf": {"tokens": torch.zeros((rows, C["seq"]), dtype=torch.int32),
             "poison": [0.0] * rows if rank == 1 else torch.zeros(rows)},
}
for case, batch in cases.items():
    step0 = trainer.state.step
    t0 = time.monotonic()
    try:
        trainer._train_step(trainer.state, batch, rng)
        got = None
    except (ValueError, RuntimeError, TypeError) as e:
        got = {"kind": type(e).__name__, "message": str(e)}
    report["refusal"][case] = {"error": got, "seconds": time.monotonic() - t0,
                               "step": trainer.state.step - step0}

# The eval step at fsdp 2, twice under the detector.
mesh = trainer.mesh
evaluate = step_mod.make_captured_eval_step(trainer.trial.evaluate,
                                            mesh=mesh)
det = Detector()
for i in range(2):
    batch = {"tokens": torch.from_numpy(TOKENS[i][rank * rows:
                                                  (rank + 1) * rows])}
    det.run(lambda: evaluate._step(trainer.state, batch))
report["eval_safety"] = det.steps

with open(os.path.join(out, f"report{rank}.json"), "w") as f:
    json.dump(report, f)
for ctx in contexts:
    ctx.close()
'''.replace("DETECTOR\n", DETECTOR)


def poison_flags():
    """[N_BATCHES, GLOBAL_BATCH]: every row of the POISON_AT-th batch."""
    flags = np.zeros((N_BATCHES, GLOBAL_BATCH), np.float32)
    flags[POISON_AT - 1] = 1.0
    return flags


class JaxGPT2(JaxTrial):
    health = HEALTH
    compile = {"upload": False}  # no second compile to export the step

    def __init__(self, context, params, tokens):
        super().__init__(context)
        self.cfg = jgpt2.Config(**DIMS, dtype=jnp.float32)
        self.params, self.tokens = params, tokens

    def init_params(self, rng):
        return jax.tree_util.tree_map(jnp.asarray, unflatten(self.params))

    def loss(self, params, batch, rng):
        loss = jgpt2.loss_fn(params, {"tokens": batch["tokens"]}, self.cfg)
        return loss * jnp.where(jnp.any(batch["poison"] > 0), jnp.nan, 1.0)

    def param_logical_axes(self):
        return jgpt2.param_logical_axes(self.cfg)

    def optimizer(self):
        sched = optax.warmup_cosine_decay_schedule(0.0, LR, 1, 100)
        return optax.chain(optax.clip_by_global_norm(1.0),
                           optax.adamw(sched, b2=0.95, weight_decay=0.1))

    def build_training_data(self):
        return [{"tokens": t, "poison": p}
                for t, p in zip(self.tokens, poison_flags())]


def jax_side(tmp, params, tokens, devices):
    """The JAX Trainer over each parity mesh on 2 virtual devices, through
    the rollback and the resume -> {case: (reports, final params)}."""
    ref = {}
    for name, mesh in PARITY.items():
        reports = []
        for length, resume in ((FIRST, None), (RESUMED, f"trial0-step{FIRST}")):
            ctx = jcore.init(max_length=length,
                             checkpoint_dir=str(tmp / f"jax_{name}"))
            trainer = JTrainer(JaxGPT2(JTrialContext(
                hparams={"mesh": mesh}, core_context=ctx), params, tokens),
                core_context=ctx, devices=devices[:WORLD])
            state = trainer.fit(report_period=2, checkpoint_period=4,
                                resume_from=resume)
            ctx.close()
            reports += ctx.train.local_training_metrics
        ref[name] = (reports, flatten(jax.tree_util.tree_map(
            np.asarray, state.params)))
    return ref


@pytest.fixture(scope="module")
def world(tmp_path_factory, devices):
    """Every case in one gloo world of 2, and the JAX side computed while
    it runs -> (the ranks' reports, the run dir, the JAX results)."""
    params = numpy_params()
    tokens = np.random.default_rng(1).integers(
        0, DIMS["vocab_size"], size=(N_BATCHES, GLOBAL_BATCH, SEQ)
    ).astype(np.int32)
    out = tmp_path_factory.mktemp("fit_mesh_captured")
    np.savez(out / "params.npz", **params)
    np.savez(out / "batches.npz", tokens=tokens, poison=poison_flags())
    script = out / "worker.py"
    script.write_text(WORKER)
    consts = json.dumps({"dims": DIMS, "lr": LR, "batch": GLOBAL_BATCH,
                         "seq": SEQ, "parity": PARITY, "health": HEALTH,
                         "first": FIRST, "resumed": RESUMED})
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(WORLD), str(out), consts],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    logs = []
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            ref = pool.submit(jax_side, out, params, tokens, devices)
            for p in procs:
                logs.append(p.communicate(timeout=TIMEOUT_S)[0])
            ref = ref.result()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    reports = [json.loads((out / f"report{r}.json").read_text())
               for r in range(WORLD)]
    return reports, out, ref


@pytest.mark.parametrize("name", list(PARITY))
def test_fit_matches_the_jax_trainer_through_rollback_and_resume(world,
                                                                 name):
    reports, out, ref = world
    jreps, jflat = ref[name]
    for rep in reports:
        assert rep["parity"][name]["step"] == RESUMED
    treps = reports[0]["parity"][name]["reports"]   # the chief reports
    steps = [r["steps_completed"] for r in treps]
    # Step 5 diverged: the window of steps 5-6 is NaN, the state goes
    # back to step 4's checkpoint, one batch is skipped, steps 5-8 run
    # again; the resume from step 8's checkpoint trains 9 and 10.
    assert steps == [r["steps_completed"] for r in jreps] == \
        [2, 4, 6, 6, 8, 10]
    for t, j in zip(treps, jreps):
        for k in ("loss", "grad_norm", "all_finite"):
            np.testing.assert_allclose(
                float(t["metrics"][k]), float(j["metrics"][k]),
                rtol=1e-5, err_msg=f"{k} at {t['steps_completed']}")
    assert treps[2]["metrics"]["divergence"] == 1.0
    assert treps[0]["metrics"]["step_captured"] == 0.0
    assert treps[0]["metrics"]["step_route"].startswith("plain: ")
    tflat = dict(np.load(out / f"final_{name}.npz"))
    d = DIMS["d_model"]
    assert set(tflat) == set(jflat)
    for k, want in jflat.items():
        got = tflat[k]
        if k == "blocks/qkv/bias":
            np.testing.assert_allclose(got[:, d:2 * d], want[:, d:2 * d],
                                       atol=2 * LR * RESUMED)
            got = np.delete(got, np.s_[d:2 * d], 1)
            want = np.delete(want, np.s_[d:2 * d], 1)
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", list(PARITY))
def test_every_rank_keeps_its_state_tensors_across_the_rollback(world, name):
    reports, _, _ = world
    for r, rep in enumerate(reports):
        around = rep["around"][name]
        # The resume at the second fit's start replaced the fresh state (no
        # step had run); the rollback wrote into each rank's live pieces.
        rollbacks = [(b, a) for into, b, a in around if into]
        assert len(rollbacks) == 1 and len(around) == 2, f"rank {r}"
        before, after = rollbacks[0]
        assert before == after and len(before) > 0, f"rank {r}"


def test_a_call_rank_1_refuses_is_refused_on_both_ranks(world):
    reports, _, _ = world
    shape = [rep["refusal"]["shape"] for rep in reports]
    for r, got in enumerate(shape):
        assert got["error"] is not None, f"rank {r} ran the step"
        assert got["step"] == 0 and got["seconds"] < 30
        # Both raise, each naming every rank's shapes.
        assert got["error"]["kind"] == "ValueError"
        assert "the ranks' batches differ" in got["error"]["message"]
        assert "rank 0: [(2, 17), (2,)]" in got["error"]["message"]
        assert "rank 1: [(3, 17), (3,)]" in got["error"]["message"]
    leaf = [rep["refusal"]["leaf"] for rep in reports]
    assert leaf[1]["error"]["kind"] == "TypeError"
    assert "a batch of tensors only" in leaf[1]["error"]["message"]
    assert leaf[0]["error"]["kind"] == "RuntimeError"
    assert "rank 1 of the mesh refused this captured step call" in \
        leaf[0]["error"]["message"]
    assert all(x["step"] == 0 and x["seconds"] < 30 for x in leaf)


def test_the_eval_step_is_capture_safe_over_the_mesh(world):
    reports, _, _ = world
    steps = [rep["eval_safety"] for rep in reports]
    assert problems(steps) == []
    kinds = [c["kind"] for c in steps[0][0]["collectives"]]
    assert "_c10d_functional.all_gather_into_tensor" in kinds, kinds
