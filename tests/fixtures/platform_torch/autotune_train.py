"""Fixture trial for the port's autotune e2e: the contract of
tests/fixtures/platform/autotune_train.py on `determined_tpu_torch.core`.
Sizes above FAKE_MEMORY_LIMIT fail as an out-of-memory trial would;
the others report a throughput that grows with the batch size, so the
autotuner's best should be the largest size that fits."""

import os
import sys

# torch.utils.tensorboard imports TensorFlow where it is installed (~12 s
# an import on a CPU host; the card host has none), and the tfevents the
# port writes do not need it.
sys.modules.setdefault("tensorflow", None)

from determined_tpu_torch import core  # noqa: E402


def main() -> int:
    with core.init(async_checkpointing=False) as ctx:
        size = int(ctx.hparams["global_batch_size"])
        limit = int(os.environ.get("FAKE_MEMORY_LIMIT", "64"))
        if size > limit:
            print(f"CUDA out of memory: fake OOM at batch {size}")
            return 1
        sps = size * 10.0 / (1.0 + size / 100.0)
        for op in ctx.searcher.operations():
            ctx.train.report_validation_metrics(
                op.length, {"samples_per_second": sps})
            op.report_completed(sps)
        print(f"profiled batch {size}: {sps:.1f} samples/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
