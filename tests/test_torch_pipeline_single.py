"""GPipe checks of the port that run in one process: the default
microbatches against the JAX package's over a grid, the Trainer's
refusals, the one-process walk of the schedule, and the lint's DTL101 for a
host read in `loss_pipelined`.

These are test_torch_pipeline.py's one-process checks (its world of 4 gloo
processes runs the others); its helpers are imported from there."""

import numpy as np
import pytest
import torch

from determined_tpu.parallel import pipeline as jpipeline
from determined_tpu.parallel.mesh import MeshConfig as JMeshConfig
from determined_tpu.parallel.mesh import create_mesh as jcreate_mesh
from determined_tpu_torch.parallel import mesh as tmesh
from determined_tpu_torch.parallel import pipeline as tpipeline


def test_microbatches_default_matches_jax(devices):
    for sizes in ({"data": 8}, {"data": 2, "pipeline": 4},
                  {"data": 1, "pipeline": 2, "fsdp": 2, "tensor": 2},
                  {"data": 2, "pipeline": 2, "fsdp": 2},
                  {"data": 1, "pipeline": 8}):
        jmesh = jcreate_mesh(JMeshConfig(**sizes).resolve(8), devices)
        tcfg = tmesh.MeshConfig(**sizes).resolve(8)
        for batch in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 40, 128):
            want = jpipeline.pipeline_microbatches_default(jmesh, batch)
            assert tpipeline.pipeline_microbatches_default(
                tcfg, batch) == want, (sizes, batch)


def test_the_walk_is_the_plain_loop_and_the_ticks_are_gpipes():
    rng = np.random.default_rng(3)
    w = torch.from_numpy((0.3 * rng.normal(size=(4, 8, 8))).astype(
        np.float32)).requires_grad_()
    x = torch.from_numpy(rng.normal(size=(8, 8)).astype(np.float32))

    def block(xx, wl):
        return torch.tanh(xx @ wl)

    want = x
    for i in range(4):
        want = block(want, w[i])
    for stages, m in ((1, 1), (2, 4), (4, 2), (4, 8)):
        got = tpipeline.walk(block, w, x, stages, m)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    # A committed slot off by one tick, or two stages' slices swapped,
    # gives another function.
    late = tpipeline.walk(block, w, x, 2, 4, commit=lambda t, s, m: (
        tpipeline.commit_slot(t, s, m) + 1) % m)
    swapped = tpipeline.walk(block, w, x, 2, 4, slices=[1, 0])
    assert not torch.allclose(late, want) and \
        not torch.allclose(swapped, want)
    # Stage s runs microbatch t - s; the last stage commits in order.
    assert [tpipeline.microbatch_at(t, 1, 2, 3) for t in range(4)] == \
        [None, 0, 1, 2]
    assert [tpipeline.commit_slot(t, 4, 2) for t in range(5)] == \
        [None, None, None, 0, 1]
    assert tpipeline.ticks(4, 8) == 11
    with pytest.raises(ValueError, match="3 layers not divisible by 2"):
        tpipeline.walk(block, w[:3], x, 2, 2)
    with pytest.raises(ValueError, match="batch 8 not divisible by 3"):
        tpipeline.walk(block, w, x, 2, 3)


def test_the_trainer_refuses_what_jax_refuses(monkeypatch):
    import torch.distributed as dist

    from determined_tpu_torch.models import gpt2 as tgpt2
    from determined_tpu_torch.train import TorchTrial, Trainer
    from determined_tpu_torch.train.trial import TrialContext

    class Plain(TorchTrial):
        cfg = tgpt2.Config.tiny()

        def init_params(self, rng):
            return tgpt2.init(rng, self.cfg)

        def loss(self, params, batch, rng):
            return tgpt2.loss_fn(params, batch, self.cfg)

        def build_training_data(self):
            return []

    class Pipelined(Plain):
        def loss_pipelined(self, params, batch, rng, mesh):
            return tgpt2.loss_fn_pipelined(params, batch, self.cfg, mesh)

    class Stateful(Pipelined):
        stateful = True

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    mesh = {"pipeline": 2, "data": 2}
    with pytest.raises(ValueError, match="does not implement loss_pipelined"):
        Trainer(Plain(TrialContext(hparams={"mesh": mesh})), device="cpu")
    with pytest.raises(ValueError, match="does not support stateful"):
        Trainer(Stateful(TrialContext(hparams={"mesh": mesh})), device="cpu")
    trainer = Trainer(Pipelined(TrialContext(hparams={"mesh": mesh})),
                      device="cpu")
    assert (trainer.mesh_config.pipeline, trainer.mesh_config.data) == (2, 2)
    assert Pipelined(TrialContext()).supports_pipeline()
    assert not Pipelined(TrialContext()).supports_pipelined_eval()


def test_the_lint_reads_loss_pipelined_as_step_code():
    from determined_tpu_torch.analysis.astlint import lint_source

    src = (
        "from determined_tpu_torch.train import TorchTrial\n"
        "class T(TorchTrial):\n"
        "    def loss_pipelined(self, params, batch, rng, mesh):\n"
        "        x = batch.sum().item()\n"
        "        return batch\n"
        "    def evaluate_pipelined(self, params, batch, mesh):\n"
        "        return {'n': float(batch.mean())}\n")
    out = lint_source(src, "t.py")
    assert sorted((d.code, d.line) for d in out) == [("DTL101", 4),
                                                     ("DTL101", 7)]
