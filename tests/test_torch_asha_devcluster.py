"""An `adaptive_asha` search of the port's MNIST trial under the native
master and agent, created through the port's CLI:
examples/mnist_cuda/adaptive.yaml with `max_trials` cut from 8 to 3
(`max_length` stays 64 batches: each of the 3 brackets, one trial each,
trains its first rung, 1, 1 and 4 batches, and with divisor 4 a rung
promotes only once 4 trials have reached it, so the rungs stop all three
early), the checkpoints under the test's directory, and the entrypoint
tests/fixtures/platform_torch/mnist_cpu_trial.py (the example's trial,
the CPU asked for by name) beside the example's model_def.py. Every
trial must end COMPLETED with its validation metrics in the master, and
the rungs must stop at least one trial before `max_length`."""

import contextlib
import io
import os
import shutil

import pytest
import yaml

from determined_tpu_torch import cli
from determined_tpu_torch.experimental import Determined
from tests.test_platform_e2e import Devcluster, native_binaries  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_TRIALS, MAX_LENGTH = 3, 64


@pytest.fixture()
def cluster(tmp_path, native_binaries):  # noqa: F811
    c = Devcluster(str(tmp_path), native_binaries, slots=MAX_TRIALS)
    c.start_master()
    c.start_agent()
    yield c
    c.stop()


def test_port_mnist_adaptive_asha_under_the_native_master(cluster, tmp_path,
                                                          monkeypatch):
    with open(os.path.join(REPO, "examples", "mnist_cuda",
                           "adaptive.yaml")) as f:
        config = yaml.safe_load(f)
    assert config["searcher"]["name"] == "adaptive_asha"
    assert config["searcher"]["max_length"] == {"batches": MAX_LENGTH}
    config["searcher"]["max_trials"] = MAX_TRIALS
    config["checkpoint_storage"]["host_path"] = str(tmp_path / "ckpts")
    config["entrypoint"] = "python3 mnist_cpu_trial.py"
    context = tmp_path / "context"
    shutil.copytree(os.path.join(REPO, "examples", "mnist_cuda"), context)
    shutil.copy(os.path.join(REPO, "tests", "fixtures", "platform_torch",
                             "mnist_cpu_trial.py"), context)
    path = tmp_path / "adaptive.yaml"
    path.write_text(yaml.safe_dump(config))
    monkeypatch.setattr(cli, "TOKEN_CACHE", str(tmp_path / "tokens.json"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["-m", cluster.master_url, "experiment", "create",
                       str(path), str(context), "--follow"])
    assert rc == 0, out.getvalue()[-3000:]
    assert "COMPLETED" in out.getvalue()
    client = Determined(cluster.master_url)
    exp = client.list_experiments()[-1]
    assert exp.state == "COMPLETED"
    trials = exp.get_trials()
    assert len(trials) == MAX_TRIALS
    for t in trials:
        assert t.state == "COMPLETED", (t.id, t.state)
        assert t.searcher_metric_value is not None
        validation = list(t.iter_metrics("validation"))
        assert validation and all(
            "validation_loss" in m["metrics"] for m in validation), t.id
    # The brackets' first rungs (native/master/searcher.cc AshaSearch).
    assert sorted(t.total_batches for t in trials) == [1, 1, 4]
    assert min(t.total_batches for t in trials) < MAX_LENGTH
