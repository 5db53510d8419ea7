"""Elastic resize in process on the port, and its per-rank checkpoints,
against the JAX Trainer, on the CPU.

One world of 4 gloo worker processes (a FileStore in the test's
directory, one process per rank) runs a tiny fp32 GPT-2 (numpy-drawn
params, a global batch of 8 rows, mesh `fsdp: -1`) through nine `fit`s
in turn, each with its own checkpoint directory:

  shrink    12 steps at 4 ranks, `force_resize(2, deadline=60)` after
            batch 5: the resize fires at step 6; ranks 2 and 3 stand by
  resumed   the uninterrupted counterpart: `slots=2`, resumed from the
            shrink's `trial0-step6`, fed batches 6..11
  grow      `slots=2` in the world of 4, `force_resize(4)` after batch 4
  budget    the deadline (5 s) cannot cover a save (`last_save_ms` one
            hour): the resize at step 5 restores the periodic step-4 one
  prefetch  the resize at the first poll, with the prefetcher off and on
  cluster   `core.info` set: a resize offer takes the preemption path
  fixed     `fsdp: 4` cannot resolve over 2: the preemption path too
  to_one    `slots=2`, shrunk to one rank at the first poll

then writes a state laid over `tensor: 2, fsdp: 2` (GPT-2's fused qkv in
the tensor layout) per rank and reads it back,
and, after the shrink, saves its 2-rank state through an in-process fake
Azure Blob service (the one of tests/test_torch_storage_remote.py) and
restores it. The JAX Trainer runs over 2 and 4 of the 8 virtual CPU
devices, with the same global batches and no resize, while the world
runs.

Tolerances against JAX are those of tests/test_torch_fsdp_trainer.py:
fp32 with sums in other orders, losses and grad norms rtol 1e-5, params
atol 1e-5 but the key bias (its gradient is 0 in exact arithmetic: Adam
turns fp32 noise into steps of about lr), 2 x lr x steps. A resize
changes no arithmetic: the shrunk run is held bitwise to the resumed
one.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_fsdp_trainer import JaxGPT2, numpy_params, unflatten

from determined_tpu import core as jcore
from determined_tpu.train import Trainer as JTrainer
from determined_tpu.train.trial import TrialContext as JTrialContext

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = dict(vocab_size=64, n_positions=32, d_model=32, n_layer=2, n_head=2)
GLOBAL_BATCH, SEQ, LR, N_BATCHES = 8, 17, 1e-3, 16
FSDP = {"data": 1, "fsdp": -1}
TIMEOUT_S = 150

# One rank of the world: `python worker.py RANK WORLD DIR DIMS AZURE_URL`.
# Imports only the port.
WORKER = r'''
import json, os, shutil, sys, types
import numpy as np
import torch
import torch.distributed as tdist
from determined_tpu_torch import core
from determined_tpu_torch.core._checkpoint import CheckpointContext
from determined_tpu_torch.core._distributed import DistributedContext
from determined_tpu_torch.models import gpt2
from determined_tpu_torch.parallel.mesh import batch_shard
from determined_tpu_torch.storage import cloud
from determined_tpu_torch.train import TorchTrial, Trainer, optim
from determined_tpu_torch.train import state as state_mod
from determined_tpu_torch.train.trial import TrialContext

rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
DIMS, AZURE = json.loads(sys.argv[4]), sys.argv[5]
GLOBAL_BATCH, LR = 8, 1e-3
with np.load(os.path.join(out, "batches.npz")) as f:
    TOKENS = f["tokens"]
with np.load(os.path.join(out, "params.npz")) as f:
    PARAMS = gpt2._unflatten({k: f[k] for k in f.files})
INIT_CALLS = [0]


class Trial(TorchTrial):
    def __init__(self, context, start=0, on_batch=None, action=None):
        super().__init__(context)
        self.cfg = gpt2.Config(**DIMS, dtype=torch.float32)
        self._start, self._on_batch, self._action = start, on_batch, action

    def init_params(self, rng):
        INIT_CALLS[0] += 1
        return gpt2.params_from_numpy(PARAMS, rng.device)

    def loss(self, params, batch, rng):
        return gpt2.loss_fn(params, batch, self.cfg)

    def param_logical_axes(self):
        return gpt2.param_logical_axes(self.cfg)

    def optimizer(self):
        sched = optim.warmup_cosine_decay_schedule(0.0, LR, 1, 100)
        return optim.chain(optim.clip_by_global_norm(1.0),
                           optim.adamw(sched, b2=0.95, weight_decay=0.1))

    def build_training_data(self):
        # Deterministic from its start: a resize rebuilds it for the new
        # width and skips the batches already trained on.
        d = self.context.distributed
        i, n = batch_shard(self.mesh_config(), d.rank, d.size)
        rows = GLOBAL_BATCH // n
        for b in range(self._start, len(TOKENS)):
            if b == self._on_batch and self._action is not None:
                action, self._action = self._action, None
                action()
            yield {"tokens": TOKENS[b][i * rows:(i + 1) * rows]}


dist = DistributedContext.from_allocation(
    "file://" + os.path.join(out, "store"), world, rank, backend="gloo")
contexts = []


def run(name, max_length, mesh=FSDP_MESH, slots=None, start=0,
        on_batch=None, action=None, before=None, prefetch=False,
        cluster=False, **fit_kw):
    d = os.path.join(out, name)
    ctx = core.init(max_length=max_length, distributed=dist,
                    checkpoint_dir=os.path.join(d, "ckpt"),
                    async_checkpointing=False)
    contexts.append(ctx)  # closed at the end: close() ends the group
    if cluster:
        ctx.info = types.SimpleNamespace(trial=None)  # as if managed
    trial = Trial(TrialContext(hparams={"mesh": mesh}, core_context=ctx,
                               global_batch_size=GLOBAL_BATCH),
                  start=start, on_batch=on_batch,
                  action=action and (lambda: action(ctx)))
    trial.prefetch = prefetch
    trainer = Trainer(trial, core_context=ctx, device="cpu", slots=slots)
    if before is not None:
        before(ctx)
    INIT_CALLS[0] = 0
    state = trainer.fit(report_period=1, preempt_period=1, **fit_kw)
    mine = {"step": None if state is None else state.step,
            "init_calls": INIT_CALLS[0],
            "restore_bytes": ctx.checkpoint.last_restore_bytes,
            "mesh": None if trainer.mesh.get_coordinate() is None
            else trainer.mesh.size()}
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(mine, f)
    if state is not None:
        full = state_mod.unshard_state(state)  # over the mesh's ranks
        if rank == 0:
            ctx.tracer.flush()
            mu = full.opt_state[1]["mu"]
            np.savez(os.path.join(d, "final.npz"),
                     **gpt2._flatten(gpt2.params_to_numpy(full.params)),
                     **{f"mu/{i}": m.numpy() for i, m in enumerate(mu)})
            with open(os.path.join(d, "report.json"), "w") as f:
                json.dump({
                    "metrics": [[r["steps_completed"], r["metrics"]] for r in
                                ctx.train.local_training_metrics],
                    "checkpoints": ctx.checkpoint.lineage(),
                    "spans": ctx.tracer.local_spans}, f)
    return state


def force(target, deadline=None):
    return lambda ctx: ctx.preempt.force_resize(target, deadline=deadline)


def blow_budget(ctx):
    ctx.checkpoint.last_save_ms = 3_600_000.0
    ctx.preempt.force_resize(2, deadline=5.0)


state = run("shrink", 12, on_batch=5, action=force(2, 60.0))
if state is not None:
    # The shrunk state through a staged backend, written per rank.
    azure = CheckpointContext(
        cloud.AzureStorageManager("ckpts", AZURE), distributed=dist,
        async_save=True)
    sid = azure.save_state(state_mod.checkpoint_view(state), state.step)
    azure.wait()
    back = state_mod.from_checkpoint_view(azure.restore_state(
        sid, state_mod.checkpoint_view(state)))
    same = [torch.equal(a._local_tensor, b._local_tensor)
            for a, b in zip(back.leaves(), state.leaves())]
    same += [torch.equal(a, b) for a, b in zip(
        back.opt_state[1]["mu"], state.opt_state[1]["mu"])]
    with open(os.path.join(out, f"azure{rank}.json"), "w") as f:
        json.dump({"sid": sid, "same": all(same),
                   "bytes": azure.last_restore_bytes}, f)
tdist.barrier()
if rank == 0:
    src = os.path.join(out, "shrink", "ckpt", "trial0-step6")
    shutil.copytree(src, os.path.join(out, "resumed", "ckpt",
                                      "trial0-step6"))
tdist.barrier()
run("resumed", 12, slots=2, start=6, resume_from="trial0-step6")
run("grow", 10, slots=2, on_batch=4, action=force(4))
run("budget", 12, on_batch=4, action=blow_budget, checkpoint_period=2)
run("prefetch_off", 12, before=force(2, 60.0))
run("prefetch_on", 12, before=force(2, 60.0), prefetch={"depth": 3})
run("cluster", 12, before=force(2), cluster=True)
run("fixed", 12, mesh={"data": 1, "fsdp": 4}, before=force(2))
run("to_one", 4, slots=2, before=force(1))
# A state over tensor 2 x fsdp 2 (the fused qkv in the tensor layout),
# written per rank and read back at its own width.
from determined_tpu_torch.parallel.mesh import MeshConfig, create_mesh
dist.resize(4)
cfg = gpt2.Config(**DIMS, dtype=torch.float32)
state = state_mod.create_train_state(
    lambda g: gpt2.params_from_numpy(PARAMS, "cpu"),
    Trial(TrialContext()).optimizer(), torch.Generator(), device="cpu",
    mesh=create_mesh(MeshConfig(data=1, fsdp=2, tensor=2), "cpu"),
    param_logical_axes=gpt2.param_logical_axes(cfg))
tp = CheckpointContext(os.path.join(out, "tensor2"), distributed=dist)
tp.save_state(state_mod.checkpoint_view(state), 0)
back = state_mod.from_checkpoint_view(tp.restore_state(
    "trial0-step0", state_mod.checkpoint_view(state)))
with open(os.path.join(out, f"tensor2.rank{rank}.json"), "w") as f:
    json.dump({"same": all(torch.equal(a._local_tensor, b._local_tensor)
                           for a, b in zip(back.leaves(), state.leaves()))},
              f)
tdist.barrier()
for ctx in contexts:
    ctx.close()
'''.replace("FSDP_MESH", json.dumps(FSDP))


def global_batches(seed=11):
    rng = np.random.default_rng(seed)
    return rng.integers(0, DIMS["vocab_size"],
                        size=(N_BATCHES, GLOBAL_BATCH, SEQ)).astype(np.int32)


def run_jax(tmp_path, params, tokens, n_devices, steps):
    """The JAX Trainer over `n_devices` virtual devices, no resize ->
    (metrics by step, final params by path)."""
    ctx = jcore.init(max_length=steps,
                     checkpoint_dir=str(tmp_path / f"jax{n_devices}"))
    trainer = JTrainer(JaxGPT2(JTrialContext(hparams={"mesh": FSDP},
                                             core_context=ctx),
                               params, tokens),
                       core_context=ctx, devices=jax.devices()[:n_devices])
    state = trainer.fit(report_period=1)
    metrics = {r["steps_completed"]: r["metrics"]
               for r in ctx.train.local_training_metrics}
    flat = {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(state.params)[0]}
    ctx.close()
    return metrics, flat


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world of 4 through its nine fits, and the JAX runs made while
    it ran -> (run dir, {n_devices: JAX run}, fake Blob service's url,
    inputs)."""
    from test_torch_storage_remote import FakeBlobService, _serve, conn_str

    out = tmp_path_factory.mktemp("elastic")
    params, tokens = numpy_params(), global_batches()
    np.savez(out / "params.npz", **params)
    np.savez(out / "batches.npz", tokens=tokens)
    (out / "worker.py").write_text(WORKER)
    FakeBlobService.store, FakeBlobService.blocks = {}, {}
    FakeBlobService.auth_failures, FakeBlobService.puts = [], []
    srv, url = _serve(FakeBlobService)
    (out / "tmp").mkdir()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
               TMPDIR=str(out / "tmp"))
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen(
        [sys.executable, str(out / "worker.py"), str(r), "4", str(out),
         json.dumps(DIMS), conn_str(url)], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    logs = []
    try:
        jax_runs = {2: run_jax(out, params, tokens[:12], 2, 12),
                    4: run_jax(out, params, tokens[:10], 4, 10)}
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-6000:]
    yield out, jax_runs, url, (params, tokens)
    srv.shutdown()
    srv.server_close()
    assert FakeBlobService.auth_failures == []


def ranks(out, name):
    return [json.loads((out / name / f"rank{r}.json").read_text())
            for r in range(4)]


def report(out, name):
    return json.loads((out / name / "report.json").read_text())


def final(out, name):
    with np.load(out / name / "final.npz") as f:
        return {k: f[k] for k in f.files}


def losses(rep, after=0):
    return [(s, m["loss"]) for s, m in rep["metrics"]
            if "loss" in m and s > after]


def assert_like_jax(rep, params, jax_run, steps, what):
    jmetrics, jfinal = jax_run
    got = {s: m for s, m in rep["metrics"] if "loss" in m}
    assert sorted(got) == list(range(1, steps + 1)), what
    for s in got:
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[s][key], jmetrics[s][key],
                                       rtol=1e-5, err_msg=f"{what} {key} {s}")
    d = DIMS["d_model"]
    for k, w in jfinal.items():
        g = params[k]
        if k == "blocks/qkv/bias":
            np.testing.assert_allclose(g[:, d:2 * d], w[:, d:2 * d],
                                       atol=2 * LR * steps, err_msg=what)
            g, w = np.delete(g, np.s_[d:2 * d], 1), \
                np.delete(w, np.s_[d:2 * d], 1)
        np.testing.assert_allclose(g, w, atol=1e-5, err_msg=f"{what} {k}")


def resize_rows(rep):
    return [(s, m) for s, m in rep["metrics"] if "resize_downtime_ms" in m]


def test_shrink_is_bitwise_the_resumed_run_and_matches_jax(world):
    out, jax_runs, _, _ = world
    got = ranks(out, "shrink")
    assert [r["step"] for r in got] == [12, 12, None, None]
    assert [r["mesh"] for r in got] == [2, 2, None, None]
    ck = out / "shrink" / "ckpt" / "trial0-step6"
    assert (ck / "COMMIT").exists()
    manifest = json.loads((ck / "manifest.json").read_text())["files"]
    assert {f"state/rank{r}.pt" for r in range(4)} | {
        "state/tree.pt", "shards.json", "metadata.json"} == set(manifest)
    rep = report(out, "shrink")
    ((step, row),) = resize_rows(rep)
    assert step == 6 and row["resize_from_slots"] == 4.0
    assert row["resize_target_slots"] == 2.0
    assert row["resize_downtime_ms"] > 0
    assert "trial0-step6" in rep["checkpoints"]

    resumed = report(out, "resumed")
    assert [r["step"] for r in ranks(out, "resumed")] == [12, 12, None, None]
    assert losses(rep, after=6) == losses(resumed, after=6)
    assert len(losses(rep, after=6)) == 6
    a, b = final(out, "shrink"), final(out, "resumed")
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert_like_jax(rep, a, jax_runs[2], 12, "shrink 4 -> 2 vs JAX")


def test_resize_spans_nest_as_the_jax_trainers(world):
    out = world[0]
    spans = report(out, "shrink")["spans"]
    (down,) = [s for s in spans if s["name"] == "harness.resize.downtime"]
    (reshard,) = [s for s in spans if s["name"] == "harness.reshard"]
    restores = [s for s in spans if s["name"] == "harness.restore"]
    assert down["attrs"] == {"from_slots": 4, "target": 2}
    assert reshard["attrs"] == {"target": 2}
    assert reshard["parent"] == down["span_id"]
    (inner,) = [s for s in restores if s["parent"] == reshard["span_id"]]
    assert inner["attrs"]["restored"] == "trial0-step6"
    assert down["start_us"] <= reshard["start_us"] <= inner["start_us"]
    assert inner["end_us"] <= reshard["end_us"] <= down["end_us"]


def test_resize_grow_in_process(world):
    out, jax_runs, _, _ = world
    got = ranks(out, "grow")
    assert [r["step"] for r in got] == [10] * 4
    assert [r["mesh"] for r in got] == [4] * 4
    rep = report(out, "grow")
    ((step, row),) = resize_rows(rep)
    assert (step, row["resize_from_slots"], row["resize_target_slots"]) == \
        (5, 2.0, 4.0)
    assert_like_jax(rep, final(out, "grow"), jax_runs[4], 10,
                    "grow 2 -> 4 vs JAX")


def test_resize_budget_exhausted_falls_back_to_lineage(world):
    out = world[0]
    assert [r["step"] for r in ranks(out, "budget")] == [12, 12, None, None]
    ckpts = out / "budget" / "ckpt"
    assert not (ckpts / "trial0-step5").exists()
    assert (ckpts / "trial0-step4" / "COMMIT").exists()
    rep = report(out, "budget")
    ((step, row),) = resize_rows(rep)
    assert step == 4  # the rewound step the restore landed on
    spans = [s for s in rep["spans"] if s["name"] == "harness.restore"]
    assert [s["attrs"]["restored"] for s in spans] == ["trial0-step4"]
    # Step 5 ran twice: on batch 4 before the resize, on batch 5 after.
    assert [s for s, _ in losses(rep)].count(5) == 2


def test_resize_with_prefetch_preserves_stream(world):
    out = world[0]
    off, on = final(out, "prefetch_off"), final(out, "prefetch_on")
    for name in ("prefetch_off", "prefetch_on"):
        assert [r["mesh"] for r in ranks(out, name)] == [2, 2, None, None]
        assert resize_rows(report(out, name))[0][0] == 1
    for k in off:
        np.testing.assert_array_equal(off[k], on[k], err_msg=k)
    assert losses(report(out, "prefetch_off")) == \
        losses(report(out, "prefetch_on"))


@pytest.mark.parametrize("name", ["cluster", "fixed"])
def test_no_resize_in_process_takes_the_preemption_path(world, name):
    """Cluster mode, and a target the mesh cannot resolve: checkpoint at
    the first poll and exit, at the old width."""
    out = world[0]
    got = ranks(out, name)
    assert [r["step"] for r in got] == [1] * 4
    assert [r["mesh"] for r in got] == [4] * 4
    rep = report(out, name)
    assert resize_rows(rep) == []
    assert rep["checkpoints"] == ["trial0-step1"]
    assert (out / name / "ckpt" / "trial0-step1" / "COMMIT").exists()


def _piece_bytes(shards, rank, size):
    """The bytes of the stored pieces that rank `rank` of `size` overlaps
    when each sharded leaf is split in `size` along the dims its pieces
    split."""
    total = 0
    for leaf in shards["leaves"].values():
        shape = leaf["shape"]
        item = torch.empty((), dtype=getattr(torch, leaf["dtype"])
                           ).element_size()
        split = [d for d in range(len(shape))
                 if len({p["offsets"][d] for p in leaf["pieces"]}) > 1]
        lo, hi = [0] * len(shape), list(shape)
        for d in split:
            n = -(-shape[d] // size)
            lo[d], hi[d] = rank * n, min(shape[d], (rank + 1) * n)
        for p in leaf["pieces"]:
            if all(max(o, a) < min(o + n, b) for o, n, a, b in
                   zip(p["offsets"], p["sizes"], lo, hi)):
                total += int(np.prod(p["sizes"])) * item
    return total


def test_a_resize_calls_no_init_params_and_reads_only_its_pieces(world):
    out = world[0]
    # Each rank's one call is its own start's; a rank a grow took in
    # restored without one.
    assert [r["init_calls"] for r in ranks(out, "shrink")] == [1] * 4
    assert [r["init_calls"] for r in ranks(out, "grow")] == [1, 1, 0, 0]
    ck = out / "shrink" / "ckpt" / "trial0-step6"
    shards = json.loads((ck / "shards.json").read_text())
    small = sum(os.path.getsize(ck / rel) for rel in
                ("metadata.json", "shards.json", "state/tree.pt"))
    stored = sum(os.path.getsize(ck / "state" / f"rank{r}.pt")
                 for r in range(4))
    for r, got in enumerate(ranks(out, "shrink")[:2]):
        want = _piece_bytes(shards, r, 2)
        assert got["restore_bytes"] == small + want
        assert want < 0.6 * stored


def _port_trial(params):
    """The workers' trial, in this process (it trains no step here)."""
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
            raise AssertionError("no step is trained")

    return Trial


def _one_process_state(params):
    from determined_tpu_torch.models import gpt2 as tgpt2
    from determined_tpu_torch.train import optim
    from determined_tpu_torch.train import state as state_mod

    sched = optim.warmup_cosine_decay_schedule(0.0, LR, 1, 100)
    tx = optim.chain(optim.clip_by_global_norm(1.0),
                     optim.adamw(sched, b2=0.95, weight_decay=0.1))
    return state_mod.create_train_state(
        lambda g: tgpt2.params_from_numpy(unflatten(params), "cpu"), tx,
        torch.Generator())


@pytest.mark.parametrize("name,sid,world_size", [
    ("shrink", "trial0-step12", 2), ("grow", "trial0-step10", 4)])
def test_a_world_checkpoint_restores_into_one_process(world, name, sid,
                                                      world_size):
    from determined_tpu_torch.core._checkpoint import CheckpointContext
    from determined_tpu_torch.models import gpt2 as tgpt2

    out, _, _, (params, _) = world
    ck = out / name / "ckpt"
    assert json.loads((ck / sid / "shards.json").read_text())["world"] == \
        world_size
    want = final(out, name)
    ctx = CheckpointContext(str(ck))
    state = ctx.restore_state(sid, _one_process_state(params))
    assert state.step == int(sid.split("step")[1])
    for k, v in tgpt2._flatten(tgpt2.params_to_numpy(state.params)).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    for i, m in enumerate(state.opt_state[1]["mu"]):
        np.testing.assert_array_equal(m.numpy(), want[f"mu/{i}"])


def test_a_replica_from_a_world_2_checkpoint_serves_its_logits(world,
                                                              tmp_path):
    """The replica built from the shrink's sharded step-12 checkpoint and
    the one built from the same state saved by one process give the same
    logits, bitwise."""
    from determined_tpu_torch.core._checkpoint import CheckpointContext
    from determined_tpu_torch.serve.task import build_replica

    out, _, _, (params, tokens) = world
    src = CheckpointContext(str(out / "shrink" / "ckpt"))
    state = src.restore_state("trial0-step12", _one_process_state(params))
    one = CheckpointContext(str(tmp_path / "one"))
    one.save_state(state, 12)
    assert (tmp_path / "one" / "trial0-step12" / "state" / "state.pt").exists()
    logits = []
    for base in (out / "shrink" / "ckpt", tmp_path / "one"):
        serving = {"model_config": {"model_size": "tiny", "dtype": "float32",
                                    **DIMS}, "checkpoint": "trial0-step12",
                   "max_batch_size": 2, "max_seq_len": 32, "kv_block_size": 8,
                   "prefill_buckets": [8, 16], "device": "cpu"}
        engine, _ = build_replica({"serving": serving, "checkpoint_storage": {
            "type": "shared_fs", "host_path": str(base)}})
        logits.append(engine.prefill_logits(0, tokens[0, 0, :11]))
    assert torch.isfinite(logits[0]).all()
    np.testing.assert_array_equal(logits[0].numpy(), logits[1].numpy())


def test_a_staged_backend_commits_and_restores_a_world_2_checkpoint(world):
    from test_torch_storage_remote import FakeBlobService, conn_str

    from determined_tpu_torch.core._checkpoint import CheckpointContext
    from determined_tpu_torch.models import gpt2 as tgpt2
    from determined_tpu_torch.storage import cloud

    out, _, url, (params, _) = world
    got = [json.loads((out / f"azure{r}.json").read_text()) for r in (0, 1)]
    assert all(g["same"] for g in got) and got[0]["sid"] == "trial0-step12"
    names = {n for (c, n) in FakeBlobService.store if c == "ckpts"}
    assert {f"trial0-step12/{rel}" for rel in (
        "COMMIT", "manifest.json", "shards.json", "metadata.json",
        "state/tree.pt", "state/rank0.pt", "state/rank1.pt")} <= names
    ctx = CheckpointContext(cloud.AzureStorageManager("ckpts", conn_str(url)))
    assert ctx.verify("trial0-step12")
    state = ctx.restore_state("trial0-step12", _one_process_state(params))
    want = final(out, "shrink")
    for k, v in tgpt2._flatten(tgpt2.params_to_numpy(state.params)).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_a_missing_or_corrupt_rank_file_walks_the_lineage_back(world,
                                                              tmp_path):
    from determined_tpu_torch import core as tcore
    from determined_tpu_torch.core._checkpoint import CheckpointContext

    out, _, _, (params, _) = world
    ck = tmp_path / "ckpt"
    shutil.copytree(out / "budget" / "ckpt", ck)
    (ck / "trial0-step12" / "state" / "rank1.pt").unlink()
    victim = ck / "trial0-step10" / "state" / "rank1.pt"
    data = bytearray(victim.read_bytes())
    data[len(data) // 2] ^= 0xFF
    victim.write_bytes(bytes(data))
    ctx = CheckpointContext(str(ck))
    template = _one_process_state(params)
    for sid, reason in (("trial0-step12", "missing file"),
                        ("trial0-step10", "checksum mismatch")):
        with pytest.raises(tcore.CorruptCheckpoint, match=reason):
            ctx.restore_state(sid, template)
    # The Trainer's restore walks back to step 8.
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train.trial import TrialContext

    Trial = _port_trial(params)
    core_ctx = tcore.init(max_length=8, checkpoint_dir=str(ck))
    state = Trainer(Trial(TrialContext(core_context=core_ctx)),
                    core_context=core_ctx,
                    device="cpu").fit(resume_from="trial0-step12")
    core_ctx.close()
    assert state.step == 8


def test_a_shrink_to_one_rank_trains_on_alone(world):
    out = world[0]
    got = ranks(out, "to_one")
    assert [r["step"] for r in got] == [4, None, None, None]
    assert got[0]["mesh"] == 1
    ((step, row),) = resize_rows(report(out, "to_one"))
    assert (step, row["resize_from_slots"], row["resize_target_slots"]) == \
        (1, 2.0, 1.0)
    # At one rank the state is plain again: the one-process format.
    ck = out / "to_one" / "ckpt"
    assert (ck / "trial0-step4" / "state" / "state.pt").exists()
    assert (ck / "trial0-step1" / "shards.json").exists()


def test_a_fused_leaf_is_converted_from_the_tensor_layout(world):
    """The tensor-2 checkpoint keeps the qkv leaves in the tensor layout
    of the width that wrote it; a one-process restore converts them back,
    and a restore at the writing width reads them as they are."""
    from determined_tpu_torch.core._checkpoint import CheckpointContext
    from determined_tpu_torch.models import gpt2 as tgpt2

    out, _, _, (params, _) = world
    assert all(json.loads((out / f"tensor2.rank{r}.json").read_text())["same"]
               for r in range(4))
    ck = out / "tensor2"
    shards = json.loads((ck / "trial0-step0" / "shards.json").read_text())
    fused = [leaf for leaf in shards["leaves"].values() if leaf["layout"]]
    assert fused and all(leaf["layout"][0][1:] == [3, 2] for leaf in fused)
    state = CheckpointContext(str(ck)).restore_state(
        "trial0-step0", _one_process_state(params))
    for k, v in tgpt2._flatten(tgpt2.params_to_numpy(state.params)).items():
        np.testing.assert_array_equal(v, params[k], err_msg=k)


@pytest.mark.parametrize("target,mesh,cluster,want", [
    (2, FSDP, False, True),
    (4, FSDP, False, False),  # the size it has
    (8, FSDP, False, False),  # beyond the world
    (2, {"data": 1, "fsdp": 4}, False, False),  # does not resolve
    (1, FSDP, True, False),  # cluster mode: the master's transition
], ids=["shrink", "same", "beyond", "unresolvable", "cluster"])
def test_can_resize_in_process_follows_the_jax_trainer(tmp_path, monkeypatch,
                                                       target, mesh, cluster,
                                                       want):
    """JAX's `_can_resize_in_process`, on a core context of 4 ranks in a
    world of 4 (the process group stood in for)."""
    import types

    import torch.distributed as dist

    from determined_tpu_torch import core as tcore
    from determined_tpu_torch.core._distributed import (
        DistributedContext,
        make_thread_transports,
    )
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train.trial import TrialContext

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    ctx = tcore.init(max_length=1, checkpoint_dir=str(tmp_path),
                     distributed=DistributedContext.for_test(
                         0, 4, make_thread_transports(4)[0]))
    if cluster:
        ctx.info = types.SimpleNamespace(trial=None)
    Trial = _port_trial(numpy_params())
    trainer = Trainer(Trial(TrialContext(hparams={"mesh": mesh},
                                         core_context=ctx)),
                      core_context=ctx, device="cpu")
    assert trainer._can_resize_in_process(target) is want


def test_piece_regions_are_distribute_fulls_cut():
    """`sharding.region` names the piece `distribute_full` cuts, for
    nested splits and uneven sizes."""
    from torch.distributed.tensor import Replicate, Shard

    from determined_tpu_torch.parallel import sharding

    full = torch.arange(7 * 10 * 3).reshape(7, 10, 3)
    for mesh_shape, placements in (
            ((2, 2), [Shard(0), Shard(1)]),
            ((4, 1), [Shard(1), Replicate()]),
            ((3, 2), [Shard(1), Shard(1)]),
            ((2, 3), [Replicate(), Shard(2)])):
        for coord in np.ndindex(mesh_shape):
            local = full
            for i, p in enumerate(placements):
                if p.is_shard():
                    local = local.chunk(mesh_shape[i], dim=p.dim)[coord[i]]
            offsets, sizes = sharding.region(full.shape, mesh_shape,
                                             placements, coord)
            assert tuple(local.shape) == sizes
            index = tuple(slice(o, o + n) for o, n in zip(offsets, sizes))
            assert torch.equal(full[index], local)
