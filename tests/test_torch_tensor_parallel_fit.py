"""GPT-2's Trainer over the `tensor` and `context` mesh axes: the port
against the JAX Trainer, on the CPU.

A world of 4 gloo processes runs test_torch_tensor_parallel.py's worker
with the fit cases only: `fit` 4 steps at `tensor 2 x context 2` with
ring and with Ulysses attention against the JAX Trainer (64 vocab rows),
ring with the uneven 65 rows against the port's one-process `fit`, and
the ring run's checkpoint restored into one process bit for bit. The
module docstring there gives the tolerances; its helpers are imported
from there."""

import shutil

import numpy as np
import pytest

from test_torch_tensor_parallel import (  # noqa: F401 (fixtures)
    DIMS,
    STEPS,
    FIT_CASES,
    inputs,
    run_world,
    assert_params,
    assert_metrics,
    port_trial_class,
)


@pytest.fixture(scope="module")
def world(tmp_path_factory, inputs, devices):
    """The fit cases in one world of 4, the JAX Trainer's runs computed
    while it runs."""
    return run_world(tmp_path_factory, inputs, devices, {}, FIT_CASES)


@pytest.mark.parametrize("name", ["ring", "ulysses"])
def test_fit_matches_the_jax_trainer(world, name):
    reports, out, ref = world
    run = reports[0][f"fit_{name}"]
    assert run["mesh"]["tensor"] == 2 and run["mesh"]["context"] == 2
    jmetrics, jfinal, jmesh = ref[f"fit_{name}"]
    assert (jmesh["tensor"], jmesh["context"]) == (2, 2)
    assert_metrics(run["metrics"], jmetrics, name)
    assert_params(dict(np.load(out / f"fit_{name}.npz")), jfinal, name)
    assert run["checkpoints"] == [f"trial0-step{STEPS}"]


def test_fit_with_an_uneven_vocab_matches_one_process(tmp_path, world,
                                                      inputs):
    from determined_tpu_torch import core as tcore
    from determined_tpu_torch.models import gpt2 as tgpt2
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train.trial import TrialContext

    reports, out, _ = world
    run = reports[0]["fit_ring_uneven"]
    Trial = port_trial_class(*inputs, DIMS["vocab_size"])
    ctx = tcore.init(max_length=STEPS, checkpoint_dir=str(tmp_path / "one"))
    state = Trainer(Trial(TrialContext(core_context=ctx)), core_context=ctx,
                    device="cpu").fit(report_period=1)
    metrics = [r["metrics"] for r in ctx.train.local_training_metrics]
    ctx.close()
    assert_metrics(run["metrics"], metrics, "uneven vocab")
    assert_params(dict(np.load(out / "fit_ring_uneven.npz")),
                  tgpt2._flatten(tgpt2.params_to_numpy(state.params)),
                  "uneven vocab")


def test_the_checkpoint_restores_into_one_process(tmp_path, world, inputs):
    from determined_tpu_torch import core as tcore
    from determined_tpu_torch.models import gpt2 as tgpt2
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train.trial import TrialContext

    reports, out, _ = world
    (sid,) = reports[0]["fit_ring"]["checkpoints"]
    final = dict(np.load(out / "fit_ring.npz"))
    shutil.copytree(out / "ckpt_ring", tmp_path / "ckpt")
    Trial = port_trial_class(*inputs, FIT_CASES["ring"][1])
    ctx = tcore.init(max_length=STEPS, checkpoint_dir=str(tmp_path / "ckpt"))
    state = Trainer(Trial(TrialContext(core_context=ctx)), core_context=ctx,
                    device="cpu").fit(resume_from=sid)  # at max_length
    ctx.close()
    assert state.step == STEPS
    restored = tgpt2._flatten(tgpt2.params_to_numpy(state.params))
    for k, v in final.items():
        np.testing.assert_array_equal(restored[k], v, err_msg=k)
