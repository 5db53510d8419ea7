"""MNIST CNN trial on CUDA devices — the PyTorch port's counterpart of
examples/mnist/model_def.py (the quickstart, one device).

The same hparams (`learning_rate`, `hidden`, `global_batch_size`,
`data_path`), the same data (an MNIST `.npz` with x_train, y_train,
x_test, y_test from `data_path` or MNIST_NPZ when present, else the same
deterministic synthetic stand-in), the same batch order, the same
optimizer (SGD with momentum 0.9) and the same evaluation. It imports
only the port. Launched with the `DET_*` variables an agent sets
(config.yaml, adaptive.yaml), `python3 model_def.py` is a managed trial on
the first CUDA device; in local mode `core.init()` needs a `max_length`
(chip_smoke.py phase 13a). The model computes over the data and fsdp mesh
axes only.
"""

import os

import numpy as np

from determined_tpu_torch import core
from determined_tpu_torch.models import mnist
from determined_tpu_torch.parallel.mesh import batch_shard
from determined_tpu_torch.train import TorchTrial, Trainer, optim
from determined_tpu_torch.train.trial import TrialContext


def _load_mnist(path):
    if path and os.path.exists(path):
        with np.load(path) as d:
            return (
                (d["x_train"], d["y_train"].astype(np.int32)),
                (d["x_test"], d["y_test"].astype(np.int32)),
            )
    rng = np.random.default_rng(0)
    n_train, n_test = 4096, 512
    x_train = rng.normal(0.1307, 0.3081, (n_train, 28, 28)).astype(np.float32)
    y_train = rng.integers(0, 10, n_train).astype(np.int32)
    # plant a learnable signal: brighten a class-dependent patch
    for i in range(n_train):
        c = y_train[i]
        x_train[i, c : c + 3, c : c + 3] += 2.0
    x_test = rng.normal(0.1307, 0.3081, (n_test, 28, 28)).astype(np.float32)
    y_test = rng.integers(0, 10, n_test).astype(np.int32)
    for i in range(n_test):
        c = y_test[i]
        x_test[i, c : c + 3, c : c + 3] += 2.0
    return (x_train, y_train), (x_test, y_test)


class MNistTrial(TorchTrial):
    def __init__(self, context: TrialContext):
        super().__init__(context)
        self.cfg = mnist.Config(
            hidden=int(context.get_hparam("hidden", 128)),
        )
        path = context.hparams.get("data_path") or os.environ.get("MNIST_NPZ")
        (self.x_train, self.y_train), (self.x_test, self.y_test) = _load_mnist(path)

    def init_params(self, rng):
        return mnist.init(rng, self.cfg)

    def loss(self, params, batch, rng):
        return mnist.loss_fn(params, batch, self.cfg)

    def param_logical_axes(self):
        return mnist.param_logical_axes(self.cfg)

    def supports_model_parallel(self):
        return False

    def optimizer(self):
        return optim.sgd(
            self.context.get_hparam("learning_rate", 0.05), momentum=0.9
        )

    def _rows(self, batch):
        """This rank's rows of a global batch; one process holds the
        whole batch."""
        d = self.context.distributed
        if d.size == 1:
            return batch
        i, count = batch_shard(self.mesh_config(), d.rank, d.size)
        n = len(batch["labels"]) // count
        return {k: v[i * n:(i + 1) * n] for k, v in batch.items()}

    def build_training_data(self):
        b = self.context.global_batch_size
        rng = np.random.default_rng(1)
        n = len(self.x_train)
        while True:
            idx = rng.integers(0, n, b)
            yield self._rows({
                "images": self.x_train[idx][..., None],
                "labels": self.y_train[idx],
            })

    def build_validation_data(self):
        b = max(self.context.global_batch_size, 64)
        for i in range(0, len(self.x_test) - b + 1, b):
            yield self._rows({
                "images": self.x_test[i : i + b][..., None],
                "labels": self.y_test[i : i + b],
            })

    def evaluate(self, params, batch):
        loss, aux = mnist.loss_fn(params, batch, self.cfg)
        return {"validation_loss": loss, "accuracy": aux["accuracy"]}


if __name__ == "__main__":
    with core.init() as ctx:
        trial = MNistTrial(
            TrialContext(hparams=ctx.hparams, core_context=ctx,
                         n_devices=ctx.distributed.size)
        )
        Trainer(trial, core_context=ctx).fit(validation_period=0,
                                             report_period=10)
