"""GPT-2 pretraining through the PyTorchTrial API on CUDA — the port's
counterpart of examples/gpt2_torch/model_def.py.

The JAX package's example trains HuggingFace's `GPT2LMHeadModel`. This one
trains the port's own GPT-2 (`determined_tpu_torch.models.gpt2`): an
`nn.Module` that holds `gpt2.init`'s parameters as `nn.Parameter`s and
computes `gpt2.loss_fn`, so its attention is the port's hand-written
flash kernels (through their `autograd.Function`), where HuggingFace's
model would run its own attention and none of the port's kernels. Compute
is bf16 and the params fp32 (`compute_dtype: float32` for an fp32 run).

The same hparams as the JAX example (`model_size`, `seq_len`,
`learning_rate`, `per_device_batch_size`, `tokens_path`), the same
synthetic token set and `torch.optim.AdamW`. Launched by the GPU-slot
launcher (distributed.yaml), one process per slot:

    python3 -m determined_tpu_torch.launch.torch_distributed -- python3 model_def.py

each process trains its DistributedSampler shard, with the model wrapped
in DDP over NCCL. `GPT2ZeroTrial` is the same model as a DeepSpeedTrial
on the port's ZeRO-1 engine (`micro_batch_size`, `gradient_accumulation`).
"""

import os

import numpy as np
import torch

from determined_tpu_torch.models import gpt2
from determined_tpu_torch.pytorch import (
    DataLoader,
    DeepSpeedTrial,
    PyTorchTrial,
    PyTorchTrialContext,
    Trainer,
    ZeroOneEngine,
)


class SyntheticTokens(torch.utils.data.Dataset):
    """Deterministic synthetic token stream (air-gapped); point
    hyperparameters.tokens_path at an int32 memmap for real data."""

    def __init__(self, vocab, seq_len, n=4096, path=None, seed=0):
        self.seq_len = seq_len
        if path:
            self.tokens = np.memmap(path, dtype=np.int32, mode="r")
            self.n = (len(self.tokens) - 1) // seq_len
        else:
            rng = np.random.default_rng(seed)
            self.tokens = rng.integers(
                0, vocab, size=(n * seq_len + 1,)).astype(np.int64)
            self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        chunk = np.asarray(
            self.tokens[i * self.seq_len : (i + 1) * self.seq_len + 1],
            dtype=np.int64,
        )
        return {"input_ids": torch.from_numpy(chunk[:-1]),
                "labels": torch.from_numpy(chunk[1:])}


def model_config(hp) -> gpt2.Config:
    """The GPT-2 preset `model_size` names, widened to `seq_len`."""
    base = {"tiny": gpt2.Config.tiny, "small": gpt2.Config.small,
            "medium": gpt2.Config.medium,
            "large": gpt2.Config.large}[hp.get("model_size", "small")]()
    seq_len = int(hp.get("seq_len", 128))
    return gpt2.Config(
        vocab_size=base.vocab_size,
        n_positions=max(base.n_positions, seq_len),
        d_model=base.d_model, n_layer=base.n_layer, n_head=base.n_head,
        dtype=getattr(torch, hp.get("compute_dtype", "bfloat16")))


class GPT2Module(torch.nn.Module):
    """The port's GPT-2 as a module: `gpt2.init`'s params (drawn from
    `seed` on the CPU, so every device starts alike) as parameters named
    by their path in the tree; `forward` is the mean next-token loss."""

    def __init__(self, cfg: gpt2.Config, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        params = gpt2.init(torch.Generator().manual_seed(seed), cfg)
        self.params = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(v)
             for k, v in gpt2._flatten(params).items()})

    def tree(self):
        return gpt2._unflatten(dict(self.params.items()))

    def forward(self, batch):
        return gpt2.loss_fn(self.tree(), {"tokens": batch["input_ids"],
                                          "targets": batch["labels"]},
                            self.cfg)


class GPT2TorchTrial(PyTorchTrial):
    def __init__(self, context: PyTorchTrialContext):
        super().__init__(context)
        hp = context.get_hparams()
        self.cfg = model_config(hp)
        self.seq_len = int(hp.get("seq_len", 128))
        self.model = context.wrap_model(
            GPT2Module(self.cfg, int(hp.get("seed", 0))))
        self.opt = context.wrap_optimizer(
            torch.optim.AdamW(self.model.parameters(),
                              lr=float(hp.get("learning_rate", 3e-4))))

    def build_training_data_loader(self):
        hp = self.context.get_hparams()
        return DataLoader(
            SyntheticTokens(self.cfg.vocab_size, self.seq_len,
                            path=hp.get("tokens_path")),
            batch_size=int(hp.get("per_device_batch_size", 8)),
        )

    def build_validation_data_loader(self):
        return DataLoader(
            SyntheticTokens(self.cfg.vocab_size, self.seq_len, n=64, seed=7),
            batch_size=int(
                self.context.get_hparams().get("per_device_batch_size", 8)),
        )

    def train_batch(self, batch, epoch_idx, batch_idx):
        loss = self.model(batch)
        self.context.backward(loss)
        self.context.step_optimizer(self.opt)
        return {"loss": loss.item()}

    def evaluate_batch(self, batch, batch_idx):
        with torch.no_grad():
            return {"val_loss": self.model(batch).item()}


class GPT2ZeroTrial(DeepSpeedTrial):
    """The same model and data as a DeepSpeedTrial on the ZeRO-1 engine:
    each train_batch pulls `gradient_accumulation` micro batches of
    `micro_batch_size` rows and steps the engine after each."""

    def __init__(self, context):
        super().__init__(context)
        hp = context.get_hparams()
        self.cfg = model_config(hp)
        self.seq_len = int(hp.get("seq_len", 128))
        lr = float(hp.get("learning_rate", 3e-4))
        self.engine = context.wrap_model_engine(ZeroOneEngine(
            GPT2Module(self.cfg, int(hp.get("seed", 0))).to(context.device),
            lambda p: torch.optim.AdamW(p, lr=lr),
            micro_batch_size=int(hp.get("micro_batch_size", 4)),
            gradient_accumulation=int(hp.get("gradient_accumulation", 2))))

    def build_training_data_loader(self):
        return DataLoader(
            SyntheticTokens(self.cfg.vocab_size, self.seq_len,
                            path=self.context.get_hparams().get("tokens_path")),
            batch_size=self.context.get_train_micro_batch_size_per_gpu())

    def build_validation_data_loader(self):
        return DataLoader(
            SyntheticTokens(self.cfg.vocab_size, self.seq_len, n=64, seed=7),
            batch_size=self.context.get_train_micro_batch_size_per_gpu())

    def train_batch(self, dataloader_iter, epoch_idx, batch_idx):
        total = 0.0
        n = self.context.num_micro_batches_per_slot()
        for _ in range(n):
            loss = self.engine(next(dataloader_iter))
            self.engine.backward(loss)
            self.engine.step()
            total += loss.item()
        return {"loss": total / n}

    def evaluate_batch(self, dataloader_iter, batch_idx):
        with torch.no_grad():
            return {"val_loss": self.engine(next(dataloader_iter)).item()}


if __name__ == "__main__":
    from determined_tpu_torch import core

    ctx = PyTorchTrialContext()
    # GPT2_STEPS: the length of local mode's one searcher op; a managed
    # trial takes its lengths from the master's searcher.
    core_ctx = core.init(distributed=ctx.dist,
                         max_length=int(os.environ.get("GPT2_STEPS", "1000")))
    ctx._core = core_ctx
    ctx._hparams = core_ctx.hparams
    trial = GPT2TorchTrial(ctx)
    Trainer(trial, core_context=core_ctx).fit(
        searcher_metric="val_loss", report_period=10)
    core_ctx.close()
