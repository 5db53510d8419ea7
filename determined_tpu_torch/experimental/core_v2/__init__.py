"""Core API v2 — the platform as a library (unmanaged experiments).

Counterpart of determined_tpu/experimental/core_v2. The training process
runs anywhere (a workstation, a bare GPU host, another scheduler); the
master only tracks it: an experiment and a trial, their metrics and
checkpoints. No scheduling, no entry point, no agent.

    from determined_tpu_torch.experimental import core_v2

    core_v2.init(config={"name": "my-run"}, master="http://master:8080")
    for step in range(100):
        ...
        core_v2.train.report_training_metrics(step, {"loss": loss})
    core_v2.close()
"""

from determined_tpu_torch.experimental.core_v2._core_v2 import (  # noqa: F401
    Context,
    checkpoint,
    close,
    init,
    searcher,
    train,
)
