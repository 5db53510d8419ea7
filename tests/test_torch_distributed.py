"""The port's control plane against the JAX package's, on the CPU.

The same payloads go through the byte and object collectives of
`determined_tpu_torch.core._distributed` over its thread transports (N
threads as ranks), over a real 2-process gloo group (a FileStore in the
test's directory), and through the JAX package's `make_thread_transports`
(`DistributedContext.for_test`): the results must be equal. Then the
managed core's chief-only work and broadcasts against the JAX package's,
on threads: the searcher's op lengths, the preemption flag, deadline and
resize target, deterministic checkpoint ids written once, and a sharded
`upload` against the JAX package's `test_sharded_upload_merges_resources`.
"""

import concurrent.futures as cf
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from determined_tpu.core._checkpoint import CheckpointContext as JCheckpoint
from determined_tpu.core._distributed import DistributedContext as JDist
from determined_tpu.core._distributed import (
    make_thread_transports as j_transports,
)
from determined_tpu.core._preempt import PreemptContext as JPreempt
from determined_tpu.core._searcher import SearcherContext as JSearcher
from determined_tpu.storage.base import SharedFSStorageManager
from determined_tpu_torch.core._checkpoint import CheckpointContext
from determined_tpu_torch.core._distributed import DistributedContext
from determined_tpu_torch.core._distributed import make_thread_transports
from determined_tpu_torch.core._preempt import PreemptContext
from determined_tpu_torch.core._searcher import SearcherContext

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120

# The payloads, run by every rank: in threads here and in the gloo
# workers (the source is written into their script).
WORK = r'''
import numpy as np


def work(dist):
    r, n = dist.rank, dist.size
    obj = {"rank": r, "name": f"host-{r}", "files": [f"shard{r}.bin"],
           "arr": np.arange(r + 1)}
    got = dist.allgather(obj)
    out = {"allgather": [dict(g, arr=g["arr"].tolist()) for g in got]}
    out["gather"] = dist.gather(f"payload-{r}")
    out["broadcast"] = dist.broadcast(
        {"cfg": [1, 2, 3], "id": "abc"} if dist.is_chief else None)
    out["empty"] = dist.allgather("" if r % 2 else {})
    dist.barrier("mid")
    t = dist.transport
    out["bytes"] = t.allgather_bytes(bytes(range(r * 3)))
    out["bcast_bytes"] = t.broadcast_bytes(b"\x00chief\xff" * 50
                                           if dist.is_chief else b"",
                                           dist.is_chief)
    out["long"] = dist.allgather("x" * (1000 * (r + 1)))[-1][-5:]
    return out
'''

GLOO_WORKER = WORK + r'''
import os, pickle, sys
from determined_tpu_torch.core._distributed import DistributedContext

rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist = DistributedContext.from_allocation(
    "file://" + os.path.join(out, "store"), world, rank, backend="gloo")
result = work(dist)
with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(result, f)
dist.shutdown()
'''


def _work():
    ns = {}
    exec(WORK, ns)
    return ns["work"]


def run_threads(size, fn, jax_package=False):
    """fn(context) on `size` threads-as-ranks -> per-rank results."""
    if jax_package:
        ts = j_transports(size)
        ctxs = [JDist.for_test(r, size, ts[r]) for r in range(size)]
    else:
        ts = make_thread_transports(size)
        ctxs = [DistributedContext.for_test(r, size, ts[r])
                for r in range(size)]
    with cf.ThreadPoolExecutor(size) as pool:
        return list(pool.map(fn, ctxs))


def run_gloo(tmp_path, size):
    script = tmp_path / "worker.py"
    script.write_text(GLOO_WORKER)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(size), str(tmp_path)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(size)]
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    out = []
    for r in range(size):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.mark.parametrize("size", [2, 4])
def test_collectives_match_the_jax_transports(size):
    ours = run_threads(size, _work())
    theirs = run_threads(size, _work(), jax_package=True)
    assert ours == theirs
    assert ours[0]["gather"] == [f"payload-{r}" for r in range(size)]
    assert all(o["gather"] is None for o in ours[1:])
    assert ours[1]["bytes"] == [bytes(range(r * 3)) for r in range(size)]
    assert [g["arr"] for g in ours[0]["allgather"]] == \
        [list(range(r + 1)) for r in range(size)]


def test_collectives_over_two_gloo_processes(tmp_path):
    assert run_gloo(tmp_path, 2) == run_threads(2, _work())


def test_single_process_shortcuts():
    for dist in (DistributedContext.local(), JDist.local()):
        assert dist.allgather({"a": 1}) == [{"a": 1}]
        assert dist.gather("x") == ["x"]
        assert dist.broadcast(7) == 7
        dist.barrier()


class FakeSession:
    """Answers the searcher's long-poll with `lengths`, then done; records
    every call."""

    def __init__(self, lengths):
        self.lengths = list(lengths)
        self.calls = []

    def get(self, path, params=None, timeout=None, **kw):
        self.calls.append(("GET", path, dict(params or {})))
        last = int((params or {}).get("last", 0))
        nxt = [n for n in self.lengths if n > last]
        return {"op": {"length": nxt[0]}} if nxt else {"done": True}

    def post(self, path, body=None, **kw):
        self.calls.append(("POST", path, body))
        return {}


def _searcher_run(jax_package):
    def work(dist):
        session = FakeSession([10, 20])
        cls = JSearcher if jax_package else SearcherContext
        s = cls(session, trial_id=3, distributed=dist)
        lengths = []
        for op in s.operations():
            lengths.append(op.length)
            op.report_completed(0.5 * op.length)
        return lengths, session.calls

    return run_threads(3, work, jax_package)


def test_searcher_op_lengths_are_broadcast_from_the_chief():
    ours, theirs = _searcher_run(False), _searcher_run(True)
    assert ours == theirs
    assert [lengths for lengths, _ in ours] == [[10, 20]] * 3
    assert ours[0][1] and all(calls == [] for _, calls in ours[1:])


def test_preemption_decisions_are_broadcast_from_the_chief():
    def work_for(cls):
        def work(dist):
            p = cls(None, distributed=dist)
            before = p.should_preempt()
            if dist.is_chief:
                p.force_resize(6, deadline=30.0)
            flag = p.should_preempt()
            deadline = p.preemption_deadline()
            return before, flag, deadline is not None and \
                25.0 < deadline <= 30.0, p.resize_target()
        return work

    ours = run_threads(3, work_for(PreemptContext))
    theirs = run_threads(3, work_for(JPreempt), jax_package=True)
    assert ours == theirs == [(False, True, True, 6)] * 3


def test_checkpoint_ids_agree_and_the_chief_writes_once(tmp_path):
    import torch

    def work(dist):
        ctx = CheckpointContext(str(tmp_path), trial_id=2,
                                distributed=dist, async_save=dist.rank % 2)
        sid = ctx.save_state({"w": torch.full((3,), 1.5)}, 7)
        ctx.wait()  # ends in a barrier: the COMMIT is on disk for all
        return sid, ctx.lineage(), len(ctx.local_reported)

    out = run_threads(3, work)
    assert [o[0] for o in out] == ["trial2-step7"] * 3
    assert [o[1] for o in out] == [["trial2-step7"]] * 3
    assert [o[2] for o in out] == [1, 0, 0]
    state = CheckpointContext(str(tmp_path), trial_id=2).restore_state(
        "trial2-step7", {"w": torch.zeros(3)})
    assert torch.equal(state["w"], torch.full((3,), 1.5))


def test_sharded_upload_merges_resources_as_the_jax_package(tmp_path):
    def work_for(jax_package):
        root = tmp_path / ("jax" if jax_package else "port")

        def work(dist):
            if jax_package:
                ctx = JCheckpoint(None, SharedFSStorageManager(str(root)),
                                  trial_id=5, distributed=dist)
            else:
                ctx = CheckpointContext(str(root), trial_id=5,
                                        distributed=dist)
            src = root.parent / f"{root.name}-rank{dist.rank}"
            src.mkdir(parents=True, exist_ok=True)
            (src / f"shard-{dist.rank}.bin").write_bytes(
                b"x" * (100 + dist.rank))
            sid = ctx.upload(str(src), metadata={"steps_completed": 7},
                             shard=True)
            return ctx, sid

        return root, run_threads(4, work, jax_package)

    (root, ours), (jroot, theirs) = work_for(False), work_for(True)
    for results in (ours, theirs):
        ctxs, sids = zip(*results)
        assert len(set(sids)) == 1
        assert [len(c.local_reported) for c in ctxs] == [1, 0, 0, 0]
    rec, jrec = ours[0][0].local_reported[0], theirs[0][0].local_reported[0]
    assert rec["resources"] == jrec["resources"] == {
        f"shard-{r}.bin": 100 + r for r in range(4)}
    assert rec["metadata"]["steps_completed"] == 7
    sid = ours[0][1]
    stored = sorted(os.listdir(root / sid))
    assert [f for f in stored if f.startswith("shard")] == sorted(
        f for f in os.listdir(jroot / theirs[0][1]) if f.startswith("shard"))
    # The port commits it: manifest over every rank's files, then COMMIT.
    from determined_tpu_torch.core import _integrity

    _integrity.verify(str(root / sid), sid)
    assert "COMMIT" in stored


def test_profiler_trace_is_hardened_as_the_jax_packages(tmp_path, caplog):
    """torch.profiler in place of jax.profiler: a region's trace lands
    under tensorboard_dir; re-entry runs untraced; a failed start runs
    the body untraced; stop is attempted when the body raises."""
    import torch

    from determined_tpu_torch.core._profiler import ProfilerContext

    prof = ProfilerContext(None, tensorboard_dir=str(tmp_path / "tb"))
    with prof.trace("outer"):
        torch.ones(4).sum()
        with prof.trace("inner"):  # refused: already active
            pass
    files = os.listdir(tmp_path / "tb")
    assert len(files) == 1 and files[0].startswith("outer-")
    assert "already active" in caplog.text
    with pytest.raises(KeyError):
        with prof.trace("raises"):
            raise KeyError("body")
    assert not prof._trace_active
    assert len(os.listdir(tmp_path / "tb")) == 2
    (tmp_path / "file").write_text("")
    broken = ProfilerContext(None, tensorboard_dir=str(tmp_path / "file"))
    ran = []
    with broken.trace("untraced"):
        ran.append(True)
    assert ran == [True] and not broken._trace_active
    assert "start failed" in caplog.text
