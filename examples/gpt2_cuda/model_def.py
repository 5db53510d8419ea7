"""GPT-2 pretraining trial on CUDA devices — the PyTorch port's
counterpart of examples/gpt2/model_def.py.

The same hparams (`model_size`, `seq_len`, `global_batch_size`,
`learning_rate`, `warmup_steps`, `decay_steps`, `weight_decay`, `remat`,
`attention_impl`, `tokens_path`, and `num_experts` and `moe_top_k` for
the Mixture-of-Experts model), the same data (a memory-mapped int32
token file when `tokens_path` or GPT2_TOKENS names one, else uniform
random tokens from a seed), the same optimizer chain and the same
evaluation. Attention runs through the hand-written CUDA flash kernels
(`attention_impl: auto` on a CUDA device). It imports only the port:

    GPT2_STEPS=200 GPT2_TOKENS=tokens.int32 python examples/gpt2_cuda/model_def.py

trains in local mode on the first CUDA device, as the JAX example's
`__main__` does, for GPT2_STEPS steps. Launched with the `DET_*`
variables an agent sets (`DET_MASTER`, `DET_TRIAL_ID`, ...), the same
script is a managed trial: the master's searcher hands out the lengths,
and the hparams come from `DET_HPARAMS`. Through the launcher, one process
per GPU slot,

    DET_SLOT_IDS="[0,1]" python -m determined_tpu_torch.launch.torch_distributed -- python examples/gpt2_cuda/model_def.py

each rank draws the same global batches and keeps its own rows of them,
with the `mesh` hparam (`{"fsdp": 2}`) sharding the params by their
logical axes. With `num_experts` above 1 every block's FFN is a top-k
routed MoE FFN, and the mesh may add an `expert` axis (moe.yaml: 8
experts, `{"data": -1, "expert": 4}` over 8 GPU slots): each rank of an
expert group holds E / expert of the experts and the same rows. The
`context` and `tensor` axes split each row's work instead
(long_context.yaml: seq_len 8192, `attention_impl: ring`,
`{"data": -1, "context": 4}`): a rank's loader keeps whole rows, and the
model takes its chunk of the sequence and its heads, FFN and vocab
slices (models/gpt2.py). The `pipeline` axis splits the layers instead
(pipeline.yaml: `{"pipeline": 2, "data": -1, "fsdp": 2}` over 8 GPU
slots): the Trainer selects `loss_pipelined` and `evaluate_pipelined`,
and the GPipe stages run the blocks (parallel/pipeline.py); the ranks of
a pipeline group keep the same rows.
"""

import os

import numpy as np

from determined_tpu_torch import core
from determined_tpu_torch.models import gpt2
from determined_tpu_torch.parallel.mesh import batch_shard
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
            overlap_allgather=bool(opt.get("overlap_allgather", False)),
            num_experts=int(context.hparams.get("num_experts", 1)),
            moe_top_k=int(context.hparams.get("moe_top_k", 2)),
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

    def supports_expert_parallel(self):
        # Only an MoE config routes tokens over the expert axis.
        return self.cfg.num_experts > 1

    def loss_pipelined(self, params, batch, rng, mesh):
        # Selected by the Trainer whenever the config mesh has pipeline > 1
        # (GPipe over the `pipeline` axis, parallel/pipeline.py).
        return gpt2.loss_fn_pipelined(params, batch, self.cfg, mesh)

    def param_logical_axes(self):
        return gpt2.param_logical_axes(self.cfg)

    def _rows(self, batch):
        """This rank's rows of a global batch: its block of the batch
        split over the mesh's data and fsdp axes. One process (no process
        group, as the preflight loads a trial) holds the whole batch."""
        d = self.context.distributed
        if d.size == 1:
            return batch
        i, count = batch_shard(self.mesh_config(), d.rank, d.size)
        n = len(batch["tokens"]) // count
        return {k: v[i * n:(i + 1) * n] for k, v in batch.items()}

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
                yield self._rows({"tokens": np.stack(
                    [self.tokens[i : i + s + 1] for i in starts])})
        else:
            while True:
                yield self._rows({"tokens": rng.integers(
                    0, self.cfg.vocab_size, size=(b, s + 1)).astype(np.int32)})

    def build_validation_data(self):
        b, s = self.context.global_batch_size, self.seq_len
        rng = np.random.default_rng(7)
        for _ in range(4):
            yield self._rows({"tokens": rng.integers(
                0, self.cfg.vocab_size, size=(b, s + 1)).astype(np.int32)})

    def evaluate(self, params, batch):
        return {"validation_loss": gpt2.loss_fn(params, batch, self.cfg)}

    def evaluate_pipelined(self, params, batch, mesh):
        return {"validation_loss": gpt2.loss_fn_pipelined(
            params, batch, self.cfg, mesh)}


if __name__ == "__main__":
    with core.init(max_length=int(os.environ.get("GPT2_STEPS", "1000"))) \
            as ctx:
        trial = GPT2Trial(
            TrialContext(hparams=ctx.hparams, core_context=ctx,
                         n_devices=ctx.distributed.size)
        )
        Trainer(trial, core_context=ctx).fit(report_period=10)
