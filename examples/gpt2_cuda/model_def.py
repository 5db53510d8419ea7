"""GPT-2 pretraining trial on one CUDA device — the PyTorch port's
counterpart of examples/gpt2/model_def.py.

The same hparams (`model_size`, `seq_len`, `global_batch_size`,
`learning_rate`, `warmup_steps`, `decay_steps`, `weight_decay`, `remat`,
`attention_impl`, `tokens_path`), the same data (a memory-mapped int32
token file when `tokens_path` or GPT2_TOKENS names one, else uniform
random tokens from a seed), the same optimizer chain and the same
evaluation. Attention runs through the hand-written CUDA flash kernels
(`attention_impl: auto` on a CUDA device). It imports only the port:

    GPT2_STEPS=200 GPT2_TOKENS=tokens.int32 python examples/gpt2_cuda/model_def.py

trains in local mode on the first CUDA device, as the JAX example's
`__main__` does; the port has no master to hand out searcher operations,
so the length (in steps) comes from GPT2_STEPS.
"""

import os

import numpy as np

from determined_tpu_torch import core
from determined_tpu_torch.models import gpt2
from determined_tpu_torch.train import TorchTrial, Trainer
from determined_tpu_torch.train import optim
from determined_tpu_torch.train.trial import TrialContext

class GPT2Trial(TorchTrial):
    def __init__(self, context: TrialContext):
        super().__init__(context)
        size = context.hparams.get("model_size", "small")
        base = {
            "tiny": gpt2.Config.tiny,
            "small": gpt2.Config.small,
            "medium": gpt2.Config.medium,
            "large": gpt2.Config.large,
        }[size]()
        seq_len = int(context.hparams.get("seq_len", 1024))
        opt = context.optimizations
        self.cfg = gpt2.Config(
            vocab_size=base.vocab_size,
            n_positions=max(base.n_positions, seq_len),
            d_model=base.d_model,
            n_layer=base.n_layer,
            n_head=base.n_head,
            remat=bool(context.hparams.get("remat", True)),
            attention_impl=opt.get(
                "attention_impl",
                context.hparams.get("attention_impl", "flash")),
            attention_bf16=bool(opt.get("attention_bf16", False)),
            num_experts=int(context.hparams.get("num_experts", 1)),
        )
        self.seq_len = seq_len
        path = context.hparams.get("tokens_path") or os.environ.get(
            "GPT2_TOKENS")
        self.tokens = None
        if path and os.path.exists(path):
            self.tokens = np.memmap(path, dtype=np.int32, mode="r")

    def init_params(self, rng):
        return gpt2.init(rng, self.cfg)

    def flops_per_step(self):
        # fwd+bwd FLOPs per optimizer step -> profiler device_flops_util
        return (gpt2.flops_per_token(self.cfg, self.seq_len)
                * self.context.global_batch_size * self.seq_len)

    def loss(self, params, batch, rng):
        return gpt2.loss_fn(params, batch, self.cfg)

    def optimizer(self):
        lr = float(self.context.get_hparam("learning_rate", 3e-4))
        warmup = int(self.context.hparams.get("warmup_steps", 100))
        sched = optim.warmup_cosine_decay_schedule(
            0.0, lr, warmup, int(self.context.hparams.get("decay_steps", 10000))
        )
        return optim.chain(
            optim.clip_by_global_norm(1.0),
            optim.adamw(sched, b2=0.95,
                        weight_decay=float(self.context.hparams.get(
                            "weight_decay", 0.1))),
        )

    def build_training_data(self):
        b, s = self.context.global_batch_size, self.seq_len
        rng = np.random.default_rng(0)
        if self.tokens is not None:
            n = len(self.tokens) - (s + 1)
            while True:
                starts = rng.integers(0, n, b)
                yield {"tokens": np.stack(
                    [self.tokens[i : i + s + 1] for i in starts])}
        else:
            while True:
                yield {"tokens": rng.integers(
                    0, self.cfg.vocab_size, size=(b, s + 1)).astype(np.int32)}

    def build_validation_data(self):
        b, s = self.context.global_batch_size, self.seq_len
        rng = np.random.default_rng(7)
        for _ in range(4):
            yield {"tokens": rng.integers(
                0, self.cfg.vocab_size, size=(b, s + 1)).astype(np.int32)}

    def evaluate(self, params, batch):
        return {"validation_loss": gpt2.loss_fn(params, batch, self.cfg)}


if __name__ == "__main__":
    with core.init(max_length=int(os.environ.get("GPT2_STEPS", "1000"))) \
            as ctx:
        trial = GPT2Trial(
            TrialContext(hparams=ctx.hparams, core_context=ctx,
                         n_devices=ctx.distributed.size)
        )
        Trainer(trial, core_context=ctx).fit(report_period=10)
