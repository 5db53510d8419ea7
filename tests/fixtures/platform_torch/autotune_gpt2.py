"""GPT-2 small autotune trial for the port: examples/gpt2_cuda's GPT2Trial
through `Trainer.fit`'s replayed step, at the `global_batch_size` its
hparams name (full width, the rest of the hparams as the searcher sends
them). Its searcher metric is `samples_per_second` over the steps after
the first (the first is the warm-up and the capture), each timed by fit's
own report window of one step. No memory limit is faked: a size the card
cannot hold ends in `torch.OutOfMemoryError`, and the trial exits non-zero.

Started by the port's launcher, one process per GPU slot, with the
`DET_*` variables an agent sets. The last line of a trial that fits is
`RESULT {...}`: its samples/s, `max_memory_allocated` and the flash
wrappers' launch counts.
"""

import json
import os
import sys
import time

import torch

from determined_tpu_torch import core
from determined_tpu_torch.ops import flash_attention as fa
from determined_tpu_torch.train import Trainer
from determined_tpu_torch.train.trial import TrialContext

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
sys.path.insert(0, os.path.join(ROOT, "examples", "gpt2_cuda"))
from model_def import GPT2Trial  # noqa: E402

WRAPPERS = {"fwd": fa.flash_fwd_cuda, "dq": fa.flash_dq_cuda,
            "dkv": fa.flash_dkv_cuda}


class AutotuneGPT2Trial(GPT2Trial):
    """GPT2Trial whose searcher metric is the training throughput."""

    def __init__(self, context: TrialContext):
        super().__init__(context)
        self.windows = []  # steps_per_second of each one-step report window

    def samples_per_second(self) -> float:
        steady = self.windows[1:]
        return (self.context.global_batch_size * len(steady)
                / sum(1.0 / s for s in steady))

    def searcher_metric(self, val_metrics) -> float:
        return self.samples_per_second()


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with core.init() as ctx:
        trial = AutotuneGPT2Trial(TrialContext(
            hparams=ctx.hparams, core_context=ctx,
            n_devices=ctx.distributed.size))
        report = ctx.train.report_training_metrics

        def recorded(steps_completed, metrics, *args, **kwargs):
            if "steps_per_second" in metrics:
                trial.windows.append(float(metrics["steps_per_second"]))
            return report(steps_completed, metrics, *args, **kwargs)

        ctx.train.report_training_metrics = recorded
        trainer = Trainer(trial, core_context=ctx)
        for fn in WRAPPERS.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        state = trainer.fit(report_period=1)
        torch.cuda.synchronize()
        print("RESULT " + json.dumps({
            "global_batch_size": trial.context.global_batch_size,
            "samples_per_second": trial.samples_per_second(),
            "step_ms": [1e3 / s for s in trial.windows],
            "steps": state.step, "fit_s": time.monotonic() - t0,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": {k: f.launches for k, f in WRAPPERS.items()},
            "step_route": trainer._route.get("step_route")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
