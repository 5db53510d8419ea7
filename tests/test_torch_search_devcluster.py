"""The port's custom searcher under the native master and agent: the
port's `RemoteSearchRunner` and `BatchSizeSearchMethod`, through the
port's `Determined` client, drive port trials
(tests/fixtures/platform_torch/autotune_train.py: the JAX fixture's
contract, a fake memory cliff at 64, on `determined_tpu_torch.core`) and
must find what tests/test_autotune.py::test_autotune_e2e finds for JAX
trials: best 64, with 128 failed. The agent runs every trial under the
JAX package's launch wrapper (`python3 -m determined_tpu.exec.launch`,
native/agent/main.cc), as it runs all trials; the trial itself imports
only the port."""

import os

import pytest

from determined_tpu_torch.autotune import BatchSizeSearchMethod
from determined_tpu_torch.experimental import Determined
from determined_tpu_torch.searcher import RemoteSearchRunner
from tests.test_platform_e2e import Devcluster, native_binaries  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "platform_torch")


@pytest.fixture()
def cluster(tmp_path, native_binaries):  # noqa: F811
    c = Devcluster(str(tmp_path), native_binaries)
    c.start_master()
    c.start_agent()
    yield c
    c.stop()


def test_port_autotune_finds_the_cliff_under_the_native_master(cluster,
                                                               tmp_path):
    client = Determined(cluster.master_url)
    # start 64 and a window of 2: 64 fits, 128 fails twice (one retry),
    # and the window (64, 128] is then tight: three trials in all.
    method = BatchSizeSearchMethod(start_size=64, max_size=512,
                                   profile_steps=2, window_factor=2.0)
    config = {
        "name": "port-autotune-batch-size",
        "entrypoint": "python3 autotune_train.py",
        "searcher": {"name": "custom", "metric": "samples_per_second",
                     "smaller_is_better": False},
        "environment": {"FAKE_MEMORY_LIMIT": "64"},
        "checkpoint_storage": {"type": "shared_fs",
                               "host_path": str(tmp_path / "ckpts")},
        "resources": {"slots_per_trial": 1},
        "max_restarts": 0,
    }
    eid = RemoteSearchRunner(method, client=client).run(
        config, model_dir=FIXTURES, poll_timeout=5)
    best, sps = method.best()
    assert best == 64, (best, method.results, method.failed_sizes)
    assert sps == pytest.approx(64 * 10.0 / 1.64)
    assert 128 in method.failed_sizes
    assert method.progress() == 1.0
    exp = client.get_experiment(eid)
    assert exp.state == "COMPLETED" and exp.progress == 1.0
    trials = sorted((t.hparams["global_batch_size"], t.state,
                     t.searcher_metric_value) for t in exp.get_trials())
    assert trials == [(64, "COMPLETED", pytest.approx(sps)),
                      (128, "ERROR", None), (128, "ERROR", None)]
    failed = [t for t in exp.get_trials() if t.state == "ERROR"]
    assert all(any("fake OOM at batch 128" in line for line in t.logs())
               for t in failed)
