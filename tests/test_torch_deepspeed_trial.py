"""The port's DeepSpeedTrial API and ZeRO-1 engine against the JAX
package's, on the CPU.

Ports of tests/test_deepspeed_trial.py's five tests (a duck-typed engine:
the microbatch-iterator `train_batch`, engine-owned backward/step,
MPU-gated reporting and data loading, engine-sharded save/load through the
checkpoint context) and tests/test_zero_engine.py's four single-process
tests, on `determined_tpu_torch.pytorch` with `device="cpu"` contexts;
where both packages run the same calls, their metrics and params must be
bitwise equal. Then `ZeroOneEngine` through `DeepSpeedTrainer` in two
processes over gloo in each package: partitioned optimizer state, owner
rebroadcast, and params, metrics and checkpoint files bitwise equal to the
JAX package's after the run.
"""

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
from determined_tpu.pytorch.zero import ZeroOneEngine as JZeroOneEngine
from determined_tpu_torch import core as tcore
from determined_tpu_torch.pytorch import (
    DataLoader,
    DeepSpeedTrainer,
    DeepSpeedTrial,
    DeepSpeedTrialContext,
    ModelParallelUnit,
    ZeroOneEngine,
)
from determined_tpu_torch.pytorch.zero import _partition

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120


class FakeEngine:
    """Duck-typed deepspeed engine: owns the model, accumulation, and
    sharded checkpoints."""

    def __init__(self, model, lr=0.05, micro_bs=8, grad_accum=2):
        self.module = model
        self.opt = torch.optim.SGD(model.parameters(), lr=lr)
        self._micro_bs = micro_bs
        self._grad_accum = grad_accum
        self.backward_calls = 0
        self.step_calls = 0
        self.saves = []
        self.loads = []

    def train_micro_batch_size_per_gpu(self):
        return self._micro_bs

    def gradient_accumulation_steps(self):
        return self._grad_accum

    def __call__(self, x):
        return self.module(x)

    def backward(self, loss):
        (loss / self._grad_accum).backward()
        self.backward_calls += 1

    def step(self):
        # deepspeed steps the optimizer only at accumulation boundaries
        self.step_calls += 1
        if self.step_calls % self._grad_accum == 0:
            self.opt.step()
            self.opt.zero_grad(set_to_none=True)

    def save_checkpoint(self, save_dir, tag=None):
        path = os.path.join(save_dir, f"{tag or 'ck'}-rank0.pt")
        torch.save(self.module.state_dict(), path)
        self.saves.append(path)

    def load_checkpoint(self, load_dir, tag=None):
        path = os.path.join(load_dir, f"{tag or 'ck'}-rank0.pt")
        self.module.load_state_dict(torch.load(path, weights_only=False))
        self.loads.append(path)


class RegressionSet(torch.utils.data.Dataset):
    def __init__(self, n=256):
        g = torch.Generator().manual_seed(0)
        self.x = torch.randn(n, 4, generator=g)
        self.y = self.x @ torch.tensor([1.0, -2.0, 3.0, 0.5]).unsqueeze(1)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def ds_trial(pkg):
    """tests/test_deepspeed_trial.py's LinearDSTrial on package `pkg`."""

    class LinearDSTrial(pkg.DeepSpeedTrial):
        def __init__(self, context):
            super().__init__(context)
            self.engine = context.wrap_model_engine(
                FakeEngine(torch.nn.Linear(4, 1)))
            self.loss_fn = torch.nn.MSELoss()

        def build_training_data_loader(self):
            return pkg.DataLoader(RegressionSet(), batch_size=8, shuffle=True)

        def build_validation_data_loader(self):
            return pkg.DataLoader(RegressionSet(64), batch_size=8)

        def train_batch(self, dataloader_iter, epoch_idx, batch_idx):
            total = 0.0
            n = self.context.num_micro_batches_per_slot()
            for _ in range(n):
                x, y = next(dataloader_iter)
                loss = self.loss_fn(self.engine(x), y)
                self.engine.backward(loss)
                self.engine.step()
                total += loss.item()
            return {"loss": total / n}

        def evaluate_batch(self, dataloader_iter, batch_idx):
            x, y = next(dataloader_iter)
            with torch.no_grad():
                return {"val_loss": self.loss_fn(self.engine(x), y).item()}

    return LinearDSTrial


def make(pkg, cls=None):
    kw = {"device": "cpu"} if pkg is not jpytorch else {}
    torch.manual_seed(0)  # the Linear's init and the loader's shuffle
    return (cls or ds_trial(pkg))(pkg.DeepSpeedTrialContext(hparams={}, **kw))


PORT = types.SimpleNamespace(
    DeepSpeedTrial=DeepSpeedTrial, DeepSpeedTrialContext=DeepSpeedTrialContext,
    DataLoader=DataLoader)


def test_deepspeed_trial_local(tmp_path):
    runs = {}
    for name, core, pkg in (("jax", jcore, jpytorch), ("torch", tcore, PORT)):
        ctx = core.init(max_length=20, checkpoint_dir=str(tmp_path / name))
        trial = make(pkg)
        trial.context._core = ctx
        trainer = (jpytorch.DeepSpeedTrainer if pkg is jpytorch
                   else DeepSpeedTrainer)(trial, core_context=ctx)
        assert trainer.fit(searcher_metric="val_loss", report_period=5) == 20
        ctx.close()
        runs[name] = (ctx, trial)
    (jctx, jtrial), (ctx, trial) = runs["jax"], runs["torch"]
    # one engine step per microbatch, grad_accum microbatches per train step
    assert trial.engine.step_calls == trial.engine.backward_calls == 20 * 2
    tm = ctx.train.local_training_metrics
    assert tm and tm[-1]["metrics"]["loss"] < tm[0]["metrics"]["loss"]
    for group in ("local_training_metrics", "local_validation_metrics"):
        assert [(m["steps_completed"], m["metrics"])
                for m in getattr(ctx.train, group)] == \
            [(m["steps_completed"], m["metrics"])
             for m in getattr(jctx.train, group)]
    assert torch.equal(trial.engine.module.weight, jtrial.engine.module.weight)
    (rec,) = ctx.checkpoint.local_reported
    assert rec["metadata"]["framework"] == "deepspeed"
    assert trial.engine.saves, "engine-sharded save must have run"
    stored = sorted(os.listdir(tmp_path / "torch" / rec["uuid"]))
    assert stored == ["COMMIT", "ds_trainer.json", "engine0-rank0.pt",
                      "manifest.json"]


def test_deepspeed_restore_roundtrip(tmp_path):
    ctx_core = tcore.init(max_length=6, checkpoint_dir=str(tmp_path))
    trial = make(PORT)
    trial.context._core = ctx_core
    DeepSpeedTrainer(trial, core_context=ctx_core).fit(
        searcher_metric="val_loss")
    sid = ctx_core.checkpoint.local_reported[-1]["uuid"]
    want = trial.engine.module.weight.detach().clone()
    ctx_core.close()

    ctx2 = tcore.init(max_length=6, checkpoint_dir=str(tmp_path))
    trial2 = make(PORT)
    trial2.context._core = ctx2
    trainer2 = DeepSpeedTrainer(trial2, core_context=ctx2)
    # A managed restart delivers the id through ClusterInfo.
    ctx2.info = types.SimpleNamespace(trial=types.SimpleNamespace(
        latest_checkpoint=sid))
    assert trainer2._restore() == 6
    assert trial2.engine.loads
    assert torch.equal(trial2.engine.module.weight, want)
    ctx2.close()


def test_mpu_gates_data_and_reporting(tmp_path):
    """A model-parallel rank that owns no data loader receives iterator
    None and must not report metrics."""
    ctx_core = tcore.init(max_length=2, checkpoint_dir=str(tmp_path))

    class MpTrial(ds_trial(PORT)):
        def __init__(self, context):
            super().__init__(context)
            context.wrap_mpu(ModelParallelUnit(
                data_parallel_rank=0, data_parallel_world_size=1,
                should_report_metrics=False,
                should_build_data_loader=False))
            self.saw_iters = []

        def train_batch(self, dataloader_iter, epoch_idx, batch_idx):
            self.saw_iters.append(dataloader_iter)
            self.engine.step()  # activation-fed rank: no data
            return {"loss": 0.0}

        def evaluate_batch(self, dataloader_iter, batch_idx):
            self.saw_iters.append(dataloader_iter)
            return {"val_loss": 0.0}

    trial = make(PORT, MpTrial)
    trial.context._core = ctx_core
    DeepSpeedTrainer(trial, core_context=ctx_core).fit(
        searcher_metric="val_loss")
    assert trial.saw_iters and all(it is None for it in trial.saw_iters)
    assert not ctx_core.train.local_training_metrics
    assert not ctx_core.train.local_validation_metrics
    ctx_core.close()


def test_auto_grad_accum_disable():
    trial = make(PORT)
    assert trial.context.num_micro_batches_per_slot() == 2
    trial.context.disable_auto_grad_accumulation()
    assert trial.context.num_micro_batches_per_slot() == 1
    assert trial.context.get_train_micro_batch_size_per_gpu() == 8


def test_trainer_requires_engine(tmp_path):
    ctx_core = tcore.init(max_length=2, checkpoint_dir=str(tmp_path))

    class NoEngine(DeepSpeedTrial):
        pass

    t = NoEngine(DeepSpeedTrialContext(hparams={}, device="cpu"))
    t.context._core = ctx_core
    with pytest.raises(ValueError, match="wrap_model_engine"):
        DeepSpeedTrainer(t, core_context=ctx_core)
    ctx_core.close()


# ------------------------------------------------------------ ZeroOneEngine


def _mlp(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Sequential(
        torch.nn.Linear(8, 16), torch.nn.ReLU(), torch.nn.Linear(16, 1))


def _train(engine_cls, x, y, steps=4, accum=2):
    eng = engine_cls(_mlp(), lambda p: torch.optim.AdamW(p, lr=1e-2),
                     micro_batch_size=4, gradient_accumulation=accum)
    for step in range(steps):
        for micro in range(accum):
            i = (step * accum + micro) * 4
            eng.backward(torch.nn.functional.mse_loss(
                eng(x[i:i + 4]), y[i:i + 4]))
            eng.step()
    return eng


class TestSingleProcess:
    def test_matches_plain_optimizer(self):
        """World size 1: ZeRO-1 is plain grad accumulation — the params
        equal a hand-rolled AdamW loop's, and the JAX package's engine's,
        bitwise."""
        torch.manual_seed(0)
        x, y = torch.randn(32, 8), torch.randn(32, 1)
        ref = _mlp()
        ref_opt = torch.optim.AdamW(ref.parameters(), lr=1e-2)
        for step in range(4):
            for micro in range(2):
                i = (step * 2 + micro) * 4
                loss = torch.nn.functional.mse_loss(ref(x[i:i + 4]),
                                                    y[i:i + 4])
                (loss / 2).backward()
            ref_opt.step()
            ref_opt.zero_grad(set_to_none=True)
        eng = _train(ZeroOneEngine, x, y)
        jeng = _train(JZeroOneEngine, x, y)
        for pr, pe, pj in zip(ref.parameters(), eng.module.parameters(),
                              jeng.module.parameters()):
            assert torch.equal(pr, pe) and torch.equal(pe, pj)

    def test_save_load_roundtrip(self, tmp_path):
        torch.manual_seed(0)
        x, y = torch.randn(8, 8), torch.randn(8, 1)
        eng = _train(ZeroOneEngine, x.repeat(4, 1), y.repeat(4, 1),
                     steps=3, accum=1)
        eng.save_checkpoint(str(tmp_path), tag="t")
        assert sorted(os.listdir(tmp_path)) == ["t-model.pt",
                                                "t-opt-rank0.pt"]
        eng2 = ZeroOneEngine(
            _mlp(seed=1), lambda p: torch.optim.AdamW(p, lr=1e-2),
            micro_batch_size=4, gradient_accumulation=1)
        eng2.load_checkpoint(str(tmp_path), tag="t")
        for a, b in zip(eng.module.parameters(), eng2.module.parameters()):
            assert torch.equal(a, b)
        assert eng2.optimizer_state_numel() == eng.optimizer_state_numel()
        s1, s2 = eng.optimizer.state_dict(), eng2.optimizer.state_dict()
        for k in s1["state"]:
            for name, v in s1["state"][k].items():
                assert torch.equal(v, s2["state"][k][name])

    def test_mixed_dtype_grads_bucketed_separately(self):
        """bf16 + fp32 params in one model: the flat buckets group by
        dtype, or torch.cat refuses. A duck-typed dist (identity
        all_reduce / broadcast) stands in for a process group."""

        class FakeDist:
            def __init__(self):
                self.reduced = []
                self.broadcasts = []

            def all_reduce(self, t):
                self.reduced.append(t.dtype)

            def broadcast(self, t, src):
                self.broadcasts.append((t.dtype, src))

        model = torch.nn.Sequential(
            torch.nn.Linear(4, 4), torch.nn.Linear(4, 1))
        model[1].to(torch.bfloat16)
        eng = ZeroOneEngine(
            model, lambda p: torch.optim.SGD(p, lr=0.1),
            micro_batch_size=1, gradient_accumulation=1)
        eng._world = 2  # force the collective paths
        for p in eng._params:
            p.grad = torch.zeros_like(p)
        fake = FakeDist()
        eng._allreduce_grads(fake)
        assert set(fake.reduced) == {torch.float32, torch.bfloat16}
        eng._rebroadcast_params(fake)
        assert {d for d, _ in fake.broadcasts} == \
            {torch.float32, torch.bfloat16}
        # the flat-bucket reason: fewer collectives than tensors
        assert len(fake.broadcasts) < len(eng._params)

    def test_partition_balance_and_determinism(self):
        params = [torch.nn.Parameter(torch.zeros(n))
                  for n in (100, 90, 80, 10, 10, 10)]
        owners = _partition(list(params), 2)
        assert owners == _partition(list(params), 2)  # deterministic
        from determined_tpu.pytorch.zero import _partition as jpartition

        assert owners == jpartition(list(params), 2)
        loads = [0, 0]
        for p, o in zip(params, owners):
            loads[o] += p.numel()
        assert abs(loads[0] - loads[1]) <= 90, loads  # roughly balanced
        assert set(owners) == {0, 1}


# One rank of a world-2 ZeRO-1 run through DeepSpeedTrainer:
# `python worker.py PKG OUT`, RANK/WORLD_SIZE/MASTER_* in the environment.
WORKER = r'''
import json, os, sys
import torch

pkg_name, out = sys.argv[1], sys.argv[2]
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
        self.x = torch.randn(n, 8, generator=g)
        self.y = (self.x ** 2).sum(1, keepdim=True)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


class ZeroTrial(pkg.DeepSpeedTrial):
    def __init__(self, context):
        super().__init__(context)
        torch.manual_seed(0)
        model = torch.nn.Sequential(
            torch.nn.Linear(8, 32), torch.nn.ReLU(), torch.nn.Linear(32, 16),
            torch.nn.ReLU(), torch.nn.Linear(16, 1))
        self.engine = context.wrap_model_engine(pkg.ZeroOneEngine(
            model, lambda p: torch.optim.AdamW(p, lr=1e-2),
            micro_batch_size=4, gradient_accumulation=2))

    def build_training_data_loader(self):
        return pkg.DataLoader(RegressionSet(), batch_size=4)

    def build_validation_data_loader(self):
        return pkg.DataLoader(RegressionSet(32), batch_size=8)

    def train_batch(self, it, epoch_idx, batch_idx):
        total = 0.0
        for _ in range(self.context.num_micro_batches_per_slot()):
            x, y = next(it)
            loss = torch.nn.functional.mse_loss(self.engine(x), y)
            self.engine.backward(loss)
            self.engine.step()
            total += loss.item()
        return {"loss": total / 2}

    def evaluate_batch(self, it, batch_idx):
        x, y = next(it)
        with torch.no_grad():
            return {"val_loss": torch.nn.functional.mse_loss(
                self.engine(x), y).item()}


ctx = pkg.DeepSpeedTrialContext(hparams={}, **kw)
assert ctx.dist is not None and ctx.dist.size == 2, ctx.dist
core_ctx = core.init(max_length=4, distributed=ctx.dist,
                     checkpoint_dir=os.path.join(out, "ckpts"),
                     async_checkpointing=False)
ctx._core = core_ctx
trial = ZeroTrial(ctx)
steps = pkg.DeepSpeedTrainer(trial, core_context=core_ctx).fit(
    searcher_metric="val_loss", report_period=2)
eng = trial.engine
params = [p.detach().reshape(-1).tolist() for p in eng.module.parameters()]
with open(os.path.join(out, f"rank{ctx.dist.rank}.json"), "w") as f:
    json.dump({"steps": steps, "params": params,
               "opt_state_numel": eng.optimizer_state_numel(),
               "total_numel": sum(p.numel() for p in eng._params),
               "n_params": len(eng._params),
               "train": [(m["steps_completed"], m["metrics"]) for m in
                         core_ctx.train.local_training_metrics],
               "val": [(m["steps_completed"], m["metrics"]) for m in
                       core_ctx.train.local_validation_metrics],
               "checkpoints": [r["resources"] for r in
                               core_ctx.checkpoint.local_reported]}, f)
core_ctx.close()
'''


def test_zero1_two_process_matches_the_jax_engine(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    runs = {}
    for pkg in ("jax", "torch"):
        out = tmp_path / pkg
        out.mkdir()
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        runs[pkg] = (out, [subprocess.Popen(
            [sys.executable, str(script), pkg, str(out)],
            env=dict(os.environ, PYTHONPATH=REPO + os.pathsep +
                     os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
                     RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                     JAX_PLATFORMS="cpu"),
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(2)])
    got = {}
    for pkg, (out, procs) in runs.items():
        try:
            logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log[-4000:]
        got[pkg] = [json.loads((out / f"rank{r}.json").read_text())
                    for r in (0, 1)]
    j, t = got["jax"], got["torch"]
    for r in (0, 1):
        for key in ("steps", "params", "opt_state_numel", "train", "val",
                    "checkpoints"):
            assert t[r][key] == j[r][key], key
    assert t[0]["steps"] == 4
    # Owner rebroadcast kept the ranks' params equal; AdamW's state (two
    # moments and a scalar step a param) is split between them.
    assert t[0]["params"] == t[1]["params"]
    numels = [t[r]["opt_state_numel"] for r in (0, 1)]
    assert sum(numels) == 2 * t[0]["total_numel"] + t[0]["n_params"]
    assert all(0 < n < 2 * t[0]["total_numel"] for n in numels)
    # Chief-only reporting; every rank's engine shard in one checkpoint.
    assert t[1]["checkpoints"] == t[1]["train"] == []
    (resources,) = t[0]["checkpoints"]
    assert sorted(resources) == ["ds_trainer.json", "engine0-model.pt",
                                 "engine0-opt-rank0.pt",
                                 "engine0-opt-rank1.pt"]
