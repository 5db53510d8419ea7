"""The port's PyTorchTrial API against the JAX package's, on the CPU.

  - tests/test_trial_apis.py's `LinearTrial` (the same seeds) through
    `determined_tpu.pytorch.Trainer` on the JAX core and through
    `determined_tpu_torch.pytorch.Trainer` (`device="cpu"`) on the port's:
    training and validation metrics, final weights and the checkpoint's
    `state.pt` bitwise equal, and the checkpoint files alike;
  - a fresh trial restores the checkpoint through `restore_path`: weights,
    optimizer state and the step;
  - world 2 over gloo (one process per rank, each through its package's
    `init_torch_distributed`): DDP in both packages, with the data sharded
    by DistributedSampler, bitwise equal weights and metrics; and a model
    sharded by FSDP2's `fully_shard`, which is not wrapped in DDP and
    saves one `state-rank{r}.pt` a rank into one checkpoint that both
    ranks restore from;
  - without `device="cpu"` (and without a card) the context raises;
  - examples/gpt2_torch_cuda at tiny width: a few steps through `fit`,
    and its checkpoint restored bitwise.
"""

import importlib.util
import json
import os
import socket
import subprocess
import sys
import types

import pytest
import torch

from determined_tpu import core as jcore
from determined_tpu import pytorch as jpytorch
from determined_tpu_torch import core as tcore
from determined_tpu_torch import pytorch as tpytorch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120


class RegressionSet(torch.utils.data.Dataset):
    def __init__(self, n=256):
        g = torch.Generator().manual_seed(0)
        self.x = torch.randn(n, 4, generator=g)
        self.y = self.x @ torch.tensor([1.0, -2.0, 3.0, 0.5]).unsqueeze(1)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def linear_trial(pkg, hparams, core_ctx):
    """tests/test_trial_apis.py's LinearTrial on package `pkg`'s API."""

    class LinearTrial(pkg.PyTorchTrial):
        def __init__(self, context):
            super().__init__(context)
            self.model = context.wrap_model(torch.nn.Linear(4, 1))
            self.opt = context.wrap_optimizer(
                torch.optim.SGD(self.model.parameters(),
                                lr=context.get_hparam("lr")))
            self.loss_fn = torch.nn.MSELoss()

        def build_training_data_loader(self):
            return pkg.DataLoader(RegressionSet(), batch_size=32, shuffle=True)

        def build_validation_data_loader(self):
            return pkg.DataLoader(RegressionSet(64), batch_size=32)

        def train_batch(self, batch, epoch_idx, batch_idx):
            x, y = batch
            loss = self.loss_fn(self.model(x), y)
            self.context.backward(loss)
            self.context.step_optimizer(self.opt)
            return {"loss": loss.item()}

        def evaluate_batch(self, batch, batch_idx):
            x, y = batch
            return {"val_loss": self.loss_fn(self.model(x), y).item()}

    kw = {"device": "cpu"} if pkg is tpytorch else {}
    torch.manual_seed(0)  # the Linear's init and the loader's shuffle
    return LinearTrial(pkg.PyTorchTrialContext(core_ctx, hparams, **kw))


def fit_both(tmp_path, max_length=30):
    """-> {pkg: (core context, trial)} after a local fit in each package."""
    out = {}
    for name, core, pkg in (("jax", jcore, jpytorch),
                            ("torch", tcore, tpytorch)):
        ctx = core.init(max_length=max_length,
                        checkpoint_dir=str(tmp_path / name))
        trial = linear_trial(pkg, {"lr": 0.1}, ctx)
        assert pkg.Trainer(trial, core_context=ctx).fit(report_period=10) \
            == max_length
        ctx.close()
        out[name] = (ctx, trial)
    return out


def _metrics(ctx):
    return ([(m["steps_completed"], m["metrics"])
             for m in ctx.train.local_training_metrics],
            [(m["steps_completed"], m["metrics"])
             for m in ctx.train.local_validation_metrics])


def _equal(a, b):
    """Nested dicts/lists of tensors and python values, bitwise."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and \
            torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            _equal(x, y) for x, y in zip(a, b))
    return a == b


def test_linear_trial_matches_the_jax_trainer(tmp_path):
    runs = fit_both(tmp_path)
    (jctx, jtrial), (tctx, ttrial) = runs["jax"], runs["torch"]
    assert _metrics(tctx) == _metrics(jctx)
    train, val = _metrics(tctx)
    assert [s for s, _ in train] == [10, 20, 30]
    assert train[-1][1]["loss"] < train[0][1]["loss"] and val[-1][1][
        "val_loss"] < 1.0
    assert torch.equal(ttrial.model.weight, jtrial.model.weight)
    assert torch.equal(ttrial.model.bias, jtrial.model.bias)
    states, files = [], []
    for ctx, name in ((jctx, "jax"), (tctx, "torch")):
        (rec,) = ctx.checkpoint.local_reported
        assert rec["metadata"]["steps_completed"] == 30
        path = tmp_path / name / rec["uuid"]
        files.append(sorted(os.listdir(path)))
        states.append(torch.load(path / "state.pt", weights_only=False))
    assert files[0] == files[1] == ["metadata.json", "state.pt"]
    assert _equal(states[1], states[0])
    assert states[1]["steps_completed"] == 30


def test_restore_through_restore_path(tmp_path):
    ctx = tcore.init(max_length=10, checkpoint_dir=str(tmp_path))
    trial = linear_trial(tpytorch, {"lr": 0.1}, ctx)
    tpytorch.Trainer(trial, core_context=ctx).fit()
    sid = ctx.checkpoint.local_reported[-1]["uuid"]
    ctx.close()

    ctx2 = tcore.init(max_length=10, checkpoint_dir=str(tmp_path))
    torch.manual_seed(1)  # another init: the restore must overwrite it
    trial2 = linear_trial(tpytorch, {"lr": 0.1}, ctx2)
    trainer2 = tpytorch.Trainer(trial2, core_context=ctx2)
    # A managed restart delivers the id through ClusterInfo.
    ctx2.info = types.SimpleNamespace(trial=types.SimpleNamespace(
        latest_checkpoint=sid, hparams={}, trial_seed=0, config={}))
    assert trainer2._restore() == 10
    assert torch.equal(trial2.model.weight, trial.model.weight)
    assert _equal(trial2.opt.state_dict(), trial.opt.state_dict())
    # fit resumes at 10: the op of 10 is already done, so it validates,
    # completes the op and saves, training nothing.
    assert trainer2.fit() == 10
    ctx2.close()


def test_the_context_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpytorch.PyTorchTrialContext(hparams={})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpytorch.DeepSpeedTrialContext(hparams={})


# ------------------------------------------------------------ world 2 gloo

# One rank of a world-2 run: `python worker.py PKG MODE OUT`, with RANK,
# WORLD_SIZE, MASTER_ADDR and MASTER_PORT in the environment.
WORKER = r'''
import json, os, sys
import torch

pkg_name, mode, out = sys.argv[1], sys.argv[2], sys.argv[3]
os.environ["DET_TORCH_BACKEND"] = "gloo"
if pkg_name == "jax":
    from determined_tpu import core
    from determined_tpu import pytorch as pkg
    kw = {}
else:
    from determined_tpu_torch import core
    from determined_tpu_torch import pytorch as pkg
    kw = {"device": "cpu"}


class RegressionSet(torch.utils.data.Dataset):
    def __init__(self, n=256):
        g = torch.Generator().manual_seed(0)
        self.x = torch.randn(n, 4, generator=g)
        self.y = self.x @ torch.tensor([1.0, -2.0, 3.0, 0.5]).unsqueeze(1)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


class Trial(pkg.PyTorchTrial):
    """tests/fixtures/torch_dist/train_ddp.py's trial; in mode "fsdp" an
    MLP sharded by fully_shard."""

    def __init__(self, context):
        super().__init__(context)
        torch.manual_seed(0)
        if mode == "fsdp":
            from torch.distributed.device_mesh import init_device_mesh
            from torch.distributed.fsdp import fully_shard

            model = torch.nn.Sequential(torch.nn.Linear(4, 8),
                                        torch.nn.ReLU(), torch.nn.Linear(8, 1))
            fully_shard(model, mesh=init_device_mesh("cpu", (2,)))
        else:
            model = torch.nn.Linear(4, 1)
        self.model = context.wrap_model(model)
        self.opt = context.wrap_optimizer(
            torch.optim.SGD(self.model.parameters(), lr=0.1))
        self.loss_fn = torch.nn.MSELoss()
        self.seen = 0

    def build_training_data_loader(self):
        return pkg.DataLoader(RegressionSet(), batch_size=16)

    def build_validation_data_loader(self):
        return pkg.DataLoader(RegressionSet(64), batch_size=16)

    def train_batch(self, batch, epoch_idx, batch_idx):
        x, y = batch
        self.seen += len(x)
        loss = self.loss_fn(self.model(x), y)
        self.context.backward(loss)
        self.context.step_optimizer(self.opt)
        return {"loss": loss.item()}

    def evaluate_batch(self, batch, batch_idx):
        x, y = batch
        return {"val_loss": self.loss_fn(self.model(x), y).item()}


def full(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).tolist()


ctx = pkg.PyTorchTrialContext(hparams={}, **kw)
assert ctx.dist is not None and ctx.dist.size == 2, ctx.dist
core_ctx = core.init(max_length=8, distributed=ctx.dist,
                     checkpoint_dir=os.path.join(out, "ckpts"),
                     async_checkpointing=False)
ctx._core = core_ctx
trial = Trial(ctx)
wrapped = type(trial.model).__name__
steps = pkg.Trainer(trial, core_context=core_ctx).fit(report_period=4)
params = {k: full(v) for k, v in trial.model.state_dict().items()}
report = {
    "steps": steps, "seen": trial.seen, "wrapped": wrapped,
    "params": params,
    "train": core_ctx.train.local_training_metrics,
    "val": core_ctx.train.local_validation_metrics,
    "checkpoints": core_ctx.checkpoint.local_reported,
}
if mode == "fsdp":
    # A fresh model restores this run's sharded checkpoint on every rank.
    sid = report["checkpoints"][-1]["uuid"] if ctx.dist.is_chief else None
    sid = ctx.dist.broadcast(sid)
    ctx.models.clear()  # the context's models are trial2's from here
    ctx.optimizers.clear()
    trial2 = Trial(ctx)
    with torch.no_grad():
        for p in trial2.model.parameters():
            p.zero_()
    core_ctx.info = type("I", (), {"trial": type(
        "T", (), {"latest_checkpoint": sid})})()
    restored = pkg.Trainer(trial2, core_context=core_ctx)._restore()
    report["restored"] = [restored, {k: full(v) for k, v in
                                     trial2.model.state_dict().items()}]
with open(os.path.join(out, f"rank{ctx.dist.rank}.json"), "w") as f:
    json.dump(report, f)
core_ctx.close()
'''


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(tmp_path, pkg, mode):
    out = tmp_path / f"{pkg}-{mode}"
    out.mkdir()
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    port = free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
                   os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
                   RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   JAX_PLATFORMS="cpu")
        procs.append(subprocess.Popen(
            [sys.executable, str(script), pkg, mode, str(out)], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return out, procs


def wait_world(out, procs):
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
    return [json.loads((out / f"rank{r}.json").read_text()) for r in (0, 1)]


def _masked(records):
    return [{k: v for k, v in r.items() if k not in ("uuid",)}
            | {"metadata": {k: v for k, v in r["metadata"].items()
                            if k != "time"}} for r in records]


def test_world2_ddp_and_fsdp2_over_gloo(tmp_path):
    started = {(pkg, mode): run_world(tmp_path, pkg, mode)
               for pkg, mode in (("jax", "ddp"), ("torch", "ddp"),
                                 ("torch", "fsdp"))}
    got = {key: wait_world(*v) for key, v in started.items()}

    jax_ranks, port_ranks = got[("jax", "ddp")], got[("torch", "ddp")]
    for r in (0, 1):
        j, t = jax_ranks[r], port_ranks[r]
        assert t["wrapped"] == j["wrapped"] == "DistributedDataParallel"
        assert t["steps"] == j["steps"] == 8
        assert t["seen"] == j["seen"] == 8 * 16  # its half of the data
        assert t["params"] == j["params"]
        for group in ("train", "val"):
            assert [(m["steps_completed"], m["metrics"]) for m in t[group]] \
                == [(m["steps_completed"], m["metrics"]) for m in j[group]]
        assert _masked(t["checkpoints"]) == _masked(j["checkpoints"])
    # DDP kept the ranks in step; only the chief reported.
    assert port_ranks[0]["params"] == port_ranks[1]["params"]
    assert len(port_ranks[0]["checkpoints"]) == 1
    assert port_ranks[1]["checkpoints"] == port_ranks[1]["train"] == []
    assert port_ranks[0]["val"][-1]["metrics"]["val_loss"] < 1.0

    f0, f1 = got[("torch", "fsdp")]
    assert f0["wrapped"] == f1["wrapped"] == "FSDPSequential"  # no DDP
    assert f0["params"] == f1["params"]
    (rec,) = f0["checkpoints"]
    assert rec["metadata"]["sharded"] is True
    assert rec["metadata"]["world_size"] == 2
    assert sorted(rec["resources"]) == ["state-rank0.pt", "state-rank1.pt"]
    stored = sorted(os.listdir(tmp_path / "torch-fsdp" / "ckpts" /
                               rec["uuid"]))
    assert stored == ["COMMIT", "manifest.json", "state-rank0.pt",
                      "state-rank1.pt"]
    for rank in (f0, f1):
        assert rank["restored"] == [8, rank["params"]]
    assert f0["train"][-1]["metrics"]["loss"] < f0["train"][0]["metrics"][
        "loss"]


# ------------------------------------------------- examples/gpt2_torch_cuda


def _example():
    spec = importlib.util.spec_from_file_location(
        "gpt2_torch_cuda_model_def",
        os.path.join(REPO, "examples", "gpt2_torch_cuda", "model_def.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TINY = {"model_size": "tiny", "seq_len": 16, "per_device_batch_size": 4,
        "learning_rate": 1e-2, "compute_dtype": "float32"}


def test_gpt2_example_trains_and_restores(tmp_path):
    from determined_tpu_torch.models import gpt2

    ex = _example()
    ctx = tcore.init(max_length=6, checkpoint_dir=str(tmp_path))
    trial = ex.GPT2TorchTrial(
        ex.PyTorchTrialContext(ctx, TINY, device="cpu"))
    # The module computes gpt2.loss_fn over gpt2.init's params.
    batch = next(iter(trial.build_training_data_loader().get_data_loader()))
    want = gpt2.loss_fn(
        gpt2.init(torch.Generator().manual_seed(0), trial.cfg),
        {"tokens": batch["input_ids"], "targets": batch["labels"]},
        trial.cfg)
    assert torch.equal(trial.model(batch), want)
    assert ex.Trainer(trial, core_context=ctx).fit(report_period=2) == 6
    losses = [m["metrics"]["loss"] for m in ctx.train.local_training_metrics]
    assert len(losses) == 3 and all(torch.isfinite(torch.tensor(losses)))
    sid = ctx.checkpoint.local_reported[-1]["uuid"]
    ctx.close()

    ctx2 = tcore.init(max_length=6, checkpoint_dir=str(tmp_path))
    trial2 = ex.GPT2TorchTrial(
        ex.PyTorchTrialContext(ctx2, dict(TINY, seed=1), device="cpu"))
    ctx2.info = types.SimpleNamespace(trial=types.SimpleNamespace(
        latest_checkpoint=sid, hparams={}, trial_seed=0, config={}))
    assert ex.Trainer(trial2, core_context=ctx2)._restore() == 6
    assert _equal(dict(trial2.model.state_dict()),
                  dict(trial.model.state_dict()))
    assert _equal(trial2.opt.state_dict(), trial.opt.state_dict())
    ctx2.close()
