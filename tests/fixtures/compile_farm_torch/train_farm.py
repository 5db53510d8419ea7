"""Compile-farm fixture of the port (docs/compile-farm-torch.md): the
counterpart of tests/fixtures/compile_farm/train_farm.py, a GPT-2
TorchTrial under the port's Trainer.

The trial class is module-level on purpose: the port's farm worker
discovers and instantiates it as the port's preflight does. The worker's
artifacts are the kernel libraries, which no hparam changes, so an lr sweep
shares them across signatures through the worker's fingerprint link.
"""

import os
import sys

import numpy as np

from determined_tpu_torch.models import gpt2
from determined_tpu_torch.train import TorchTrial, optim
from determined_tpu_torch.train.trial import TrialContext

VOCAB = 512
SEQ = 128


class FarmTrial(TorchTrial):
    prefetch = False

    def _cfg(self):
        return gpt2.Config(
            vocab_size=VOCAB,
            n_positions=SEQ,
            d_model=int(os.environ.get("FARM_D_MODEL", "512")),
            n_layer=int(os.environ.get("FARM_N_LAYER", "6")),
            n_head=8,
            remat=False,
        )

    def init_params(self, rng):
        return gpt2.init(rng, self._cfg())

    def loss(self, params, batch, rng):
        return gpt2.loss_fn(params, batch, self._cfg())

    def optimizer(self):
        return optim.adamw(float(self.context.hparams.get("lr", 1e-3)))

    def build_training_data(self):
        rng = np.random.default_rng(0)
        bs = int(self.context.hparams.get("global_batch_size", 8))
        while True:
            yield {"tokens": rng.integers(
                0, VOCAB, size=(bs, SEQ + 1)).astype(np.int32)}


def main() -> int:
    from determined_tpu_torch import core
    from determined_tpu_torch.train import Trainer

    with core.init() as ctx:
        trial = FarmTrial(TrialContext(hparams=ctx.hparams,
                                       core_context=ctx))
        Trainer(trial, core_context=ctx).fit(report_period=2)
    print("farm fixture: trial complete", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
