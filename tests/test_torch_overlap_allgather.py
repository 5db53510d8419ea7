"""`overlap_allgather` in the port's GPT-2: each layer's fsdp all-gather
issued one layer ahead of its use, as the JAX model's `_scan_overlap`
does, on the CPU.

A tiny fp32 GPT-2 trial trains 3 steps through the port's Trainer at
world 2 with `fsdp=2` (gloo over a FileStore, one worker process a rank,
as tests/test_torch_fsdp_trainer.py runs it), once with
`overlap_allgather` off and once on. Each rank's local gradient shards at
every step, the losses and grad norms of every report, and the final
params must be bitwise equal between the two runs. The flag is read: the
order of the first forward's gathers (G) and blocks (B) is G0 B0 G1 B1
without it and G0 G1 B0 B1 with it, the next layer's gather returned
before it is waited for (an AsyncCollectiveTensor).
"""

import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120

# One rank: `python worker.py RANK OVERLAP OUT`.
WORKER = r'''
import json, os, sys
import numpy as np
import torch
from determined_tpu_torch import core
from determined_tpu_torch.core._distributed import DistributedContext
from determined_tpu_torch.models import gpt2
from determined_tpu_torch.train import TorchTrial, Trainer, optim
from determined_tpu_torch.train.trial import TrialContext

rank, overlap, out = int(sys.argv[1]), sys.argv[2] == "on", sys.argv[3]
DIMS = dict(vocab_size=64, n_positions=32, d_model=32, n_layer=2, n_head=2)
GLOBAL_BATCH, SEQ, STEPS = 8, 17, 3

events = []
real_gather, real_block = gpt2._gather_layer, gpt2._block


def gather(lp, async_op=False):
    got = real_gather(lp, async_op=async_op)
    if len(events) < 4:
        leaf = got["qkv"]["kernel"]
        events.append(("G", async_op, type(leaf).__name__))
    return got


def block(x, lp, **kw):
    if len(events) < 4:
        events.append(("B",))
    return real_block(x, lp, **kw)


gpt2._gather_layer, gpt2._block = gather, block
grads = []


class Trial(TorchTrial):
    def __init__(self, context):
        super().__init__(context)
        self.cfg = gpt2.Config(**DIMS, dtype=torch.float32,
                               overlap_allgather=overlap)

    def init_params(self, rng):
        return gpt2.init(torch.Generator().manual_seed(0), self.cfg)

    def loss(self, params, batch, rng):
        return gpt2.loss_fn(params, batch, self.cfg)

    def param_logical_axes(self):
        return gpt2.param_logical_axes(self.cfg)

    def optimizer(self):
        tx = optim.chain(optim.clip_by_global_norm(1.0),
                         optim.adamw(1e-2, b2=0.95, weight_decay=0.1))

        def update(g, state, *a, **k):  # this rank's gradient shards
            grads.append([t.detach().clone() for t in g])
            return tx.update(g, state, *a, **k)

        return tx._replace(update=update)

    def build_training_data(self):
        rng = np.random.default_rng(1)
        rows = GLOBAL_BATCH // 2
        while True:
            t = rng.integers(0, DIMS["vocab_size"], size=(GLOBAL_BATCH, SEQ))
            yield {"tokens": t[rank * rows:(rank + 1) * rows].astype(np.int32)}


dist = DistributedContext.from_allocation(
    "file://" + os.path.join(out, "store"), 2, rank, backend="gloo")
ctx = core.init(max_length=STEPS, checkpoint_dir=os.path.join(out, "ckpt"),
                distributed=dist)
trial = Trial(TrialContext(hparams={"mesh": {"fsdp": 2}}, core_context=ctx,
                           global_batch_size=GLOBAL_BATCH))
state = Trainer(trial, core_context=ctx, device="cpu").fit(report_period=1)
torch.save({"grads": grads,
            "params": [p.to_local() if hasattr(p, "to_local") else p
                       for p in gpt2._flatten(state.params).values()]},
           os.path.join(out, f"rank{rank}.pt"))
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump({"events": events,
               "metrics": [r["metrics"] for r in
                           ctx.train.local_training_metrics]}, f)
ctx.close()
'''


def run(tmp_path, overlap):
    out = tmp_path / overlap
    out.mkdir()
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    return out, [subprocess.Popen(
        [sys.executable, str(script), str(r), overlap, str(out)], env=env,
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]


def collect(out, procs):
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [(json.loads((out / f"rank{r}.json").read_text()),
             torch.load(out / f"rank{r}.pt", weights_only=False))
            for r in (0, 1)]


def test_overlap_allgather_is_read_and_changes_no_bit(tmp_path):
    started = {k: run(tmp_path, k) for k in ("off", "on")}
    off, on = (collect(*started[k]) for k in ("off", "on"))
    def model_metrics(report):  # the loop's timings differ run to run
        return [(m["loss"], m["grad_norm"], m["all_finite"])
                for m in report["metrics"]]

    assert len(model_metrics(off[0][0])) == 3  # the chief reports
    for (joff, toff), (jon, ton) in zip(off, on):
        assert model_metrics(jon) == model_metrics(joff)
        assert len(ton["grads"]) == len(toff["grads"]) == 3
        for step_on, step_off in zip(ton["grads"], toff["grads"]):
            assert len(step_on) == len(step_off)
            for a, b in zip(step_on, step_off):
                assert torch.equal(a, b)
        for a, b in zip(ton["params"], toff["params"]):
            assert torch.equal(a, b)
        # The gathers as issued: without the flag each layer's just before
        # its block, waited for there; with it the next layer's first.
        assert [e[0] for e in joff["events"]] == ["G", "B", "G", "B"]
        assert [e[0] for e in jon["events"]] == ["G", "G", "B", "B"]
        assert [e[1] for e in joff["events"] if e[0] == "G"] == [False] * 2
        assert [e[1:] for e in jon["events"] if e[0] == "G"] == [
            [True, "AsyncCollectiveTensor"]] * 2
