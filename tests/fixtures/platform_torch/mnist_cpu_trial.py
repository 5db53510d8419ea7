"""examples/mnist_cuda/model_def.py's managed trial with the CPU asked for
by name: the example's MNistTrial through `Trainer.fit(device="cpu")`, as
the example's `__main__` runs it on the first CUDA device. The
devcluster tests of a host without a card copy it into a context beside
the example's model_def.py and make it the entrypoint."""

import sys

# torch.utils.tensorboard imports TensorFlow where it is installed (~12 s
# an import on a CPU host; the card host has none), and the tfevents the
# port writes do not need it.
sys.modules.setdefault("tensorflow", None)

from determined_tpu_torch import core  # noqa: E402
from determined_tpu_torch.train import Trainer  # noqa: E402
from determined_tpu_torch.train.trial import TrialContext  # noqa: E402
from model_def import MNistTrial  # noqa: E402

if __name__ == "__main__":
    with core.init() as ctx:
        trial = MNistTrial(TrialContext(hparams=ctx.hparams, core_context=ctx,
                                        n_devices=ctx.distributed.size))
        Trainer(trial, core_context=ctx, device="cpu").fit(
            validation_period=0, report_period=10)
