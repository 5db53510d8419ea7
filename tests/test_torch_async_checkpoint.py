"""Background checkpoint writes of the port's CheckpointContext, on the CPU.

  - `save_state` returns before the state file is written (the write is
    held on a gate here), and the file holds the state as it was at save
    time even though params and moments were changed in place afterwards:
    the write reads a snapshot, never the live tensors. The snapshot's
    buffers are reused by the next save;
  - a process killed between the write and its commit (a subprocess)
    leaves a PARTIAL checkpoint: `lineage()` skips it, and a Trainer asked
    to resume from it walks back to the previous COMPLETED one;
  - `last_save_ms` is set when `wait()` commits;
  - a write that fails raises at `wait()` (and at the next `save_state`
    when nobody waited), and the checkpoint stays PARTIAL;
  - without `async_save` the save is COMPLETED when `save_state` returns.

The snapshot on the card (pinned buffers, a side stream, the compute
stream waiting on its event) is held by tests/test_torch_cuda.py.
"""

import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from determined_tpu_torch.core import _integrity
from determined_tpu_torch.core._checkpoint import CheckpointContext
from determined_tpu_torch.train import TorchTrial, optim
from determined_tpu_torch.train.state import TrainState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_state(step=2):
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(4, 3, generator=gen, requires_grad=True),
              "b": torch.randn(3, generator=gen, requires_grad=True)}
    moments = {"mu": [torch.randn(4, 3, generator=gen),
                      torch.randn(3, generator=gen)],
               "nu": [torch.rand(4, 3, generator=gen),
                      torch.rand(3, generator=gen)], "count": step}
    return TrainState(step=step, params=params, opt_state=(None, moments))


def leaves(state):
    mom = state.opt_state[1]
    return [state.params["w"], state.params["b"], *mom["mu"], *mom["nu"]]


class GatedSave:
    """torch.save held until `release()`: the write is still running."""

    def __init__(self, monkeypatch):
        self._real = torch.save
        self.gate = threading.Event()
        self.entered = threading.Event()
        monkeypatch.setattr(torch, "save", self)

    def __call__(self, obj, f):
        self.entered.set()
        assert self.gate.wait(30)
        self._real(obj, f)

    def release(self):
        self.gate.set()


def test_save_returns_before_the_write_and_keeps_the_snapshot(
        tmp_path, monkeypatch):
    gated = GatedSave(monkeypatch)
    ctx = CheckpointContext(str(tmp_path), async_save=True)
    state = small_state()
    at_save = [t.detach().clone() for t in leaves(state)]
    sid = ctx.save_state(state, 2)
    assert gated.entered.wait(30)
    state_file = tmp_path / sid / "state" / "state.pt"
    assert not state_file.exists()  # the write has not happened yet
    assert [r["state"] for r in ctx.local_reported] == ["PARTIAL"]
    assert ctx.lineage() == []
    with torch.no_grad():  # the optimizer's in-place updates
        for t in leaves(state):
            t.mul_(-3.0).add_(1.0)
    gated.release()
    ctx.wait()
    assert [r["state"] for r in ctx.local_reported] == ["COMPLETED"]
    assert ctx.lineage() == [sid]
    restored = CheckpointContext(str(tmp_path)).restore_state(
        sid, small_state())
    for got, want in zip(leaves(restored), at_save):
        assert torch.equal(got, want)
    assert restored.step == 2 and restored.opt_state[1]["count"] == 2
    assert restored.params["w"].requires_grad

    buffers = list(ctx._snapshot._buffers)
    ctx.save_state(state, 4)
    ctx.wait()
    assert all(a is b for a, b in zip(ctx._snapshot._buffers, buffers))
    assert ctx.lineage() == ["trial0-step4", sid]


_CRASH = textwrap.dedent("""
    import os, sys
    from determined_tpu_torch import core
    from determined_tpu_torch.core import _integrity
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train.trial import TrialContext
    sys.path.insert(0, os.path.dirname(sys.argv[2]))
    from test_torch_async_checkpoint import LinearTrial

    real_commit = _integrity.commit
    def commit(path, storage_id, manifest):
        if storage_id.endswith("step4"):
            os._exit(3)  # killed between the write and its commit
        real_commit(path, storage_id, manifest)
    _integrity.commit = commit
    ctx = core.init(max_length=4, checkpoint_dir=sys.argv[1])
    Trainer(LinearTrial(TrialContext(core_context=ctx)), core_context=ctx,
            device="cpu").fit(report_period=1, checkpoint_period=2)
""")


class LinearTrial(TorchTrial):
    """A least-squares fit on fixed numpy batches (tiny and exact)."""

    def init_params(self, rng):
        return {"w": torch.zeros(3, device=rng.device)}

    def loss(self, params, batch, rng):
        return ((batch["x"] @ params["w"] - batch["y"]) ** 2).mean()

    def optimizer(self):
        return optim.adamw(0.1)

    def build_training_data(self):
        rng = np.random.default_rng(0)
        for _ in range(8):
            x = rng.normal(size=(5, 3)).astype(np.float32)
            yield {"x": x, "y": x @ np.array([1, -2, 3], np.float32)}


def test_a_crash_before_the_commit_leaves_a_partial_the_lineage_skips(
        tmp_path):
    from determined_tpu_torch import core
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train.trial import TrialContext

    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", _CRASH, str(tmp_path), __file__],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 3, out.stderr[-2000:]
    partial = tmp_path / "trial0-step4"
    assert (partial / "state" / "state.pt").exists()
    assert (partial / _integrity.MANIFEST_FILE).exists()
    assert not (partial / _integrity.COMMIT_FILE).exists()

    ctx = core.init(max_length=4, checkpoint_dir=str(tmp_path))
    assert ctx.checkpoint.lineage() == ["trial0-step2"]
    trainer = Trainer(LinearTrial(TrialContext(core_context=ctx)),
                      core_context=ctx, device="cpu")
    state = trainer.fit(report_period=1, resume_from="trial0-step4")
    ctx.close()
    restores = [s["attrs"] for s in ctx.tracer.local_spans
                if s["name"] == "harness.restore"]
    assert restores == [{"requested": "trial0-step4",
                         "restored": "trial0-step2"}]
    assert [r["steps_completed"]
            for r in ctx.train.local_training_metrics] == [3, 4]
    assert state.step == 4
    assert ctx.checkpoint.lineage() == ["trial0-step4", "trial0-step2"]


def test_last_save_ms_is_set_by_the_commit(tmp_path):
    ctx = CheckpointContext(str(tmp_path), async_save=True)
    ctx.save_state(small_state(), 2)
    assert ctx.last_save_ms is None
    ctx.wait()
    assert ctx.last_save_ms is not None and ctx.last_save_ms > 0
    first = ctx.last_save_ms
    ctx.wait()  # nothing pending: unchanged
    assert ctx.last_save_ms == first


def test_a_failed_write_raises_at_wait(tmp_path, monkeypatch):
    def broken(obj, f):
        raise OSError("disk full")

    ctx = CheckpointContext(str(tmp_path), async_save=True)
    monkeypatch.setattr(torch, "save", broken)
    ctx.save_state(small_state(), 2)
    with pytest.raises(RuntimeError, match="trial0-step2") as info:
        ctx.wait()
    assert isinstance(info.value.__cause__, OSError)
    assert [r["state"] for r in ctx.local_reported] == ["PARTIAL"]
    assert ctx.lineage() == []
    ctx.wait()  # raised once; nothing is pending now
    # Nobody waited: the next save raises it before it starts.
    ctx.save_state(small_state(4), 4)
    with pytest.raises(RuntimeError, match="trial0-step4"):
        ctx.save_state(small_state(6), 6)
    assert not (tmp_path / "trial0-step6").exists()


def test_without_async_save_the_checkpoint_is_committed_on_return(tmp_path):
    ctx = CheckpointContext(str(tmp_path))
    sid = ctx.save_state(small_state(), 2)
    assert [r["state"] for r in ctx.local_reported] == ["COMPLETED"]
    assert (tmp_path / sid / _integrity.COMMIT_FILE).exists()
    assert ctx.last_save_ms > 0
