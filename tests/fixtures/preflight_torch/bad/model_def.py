"""Preflight fixture for the port: a TorchTrial with exactly two defects.

  - a 32 MiB embedding with no
    sharded dimension on an
    8-slot mesh                   -> DTL002 (implicit replication)
  - .item() inside the loss       -> DTL101 (host sync in a step function)

The JAX fixture's third defect, DTL001 (state not donated), has no
counterpart: the port's step updates its state in place. Everything else
is deliberately clean: the batch divides the mesh batch axes, and there is
no Python RNG / wall clock / shape branching in the step.
"""

import numpy as np
import torch

from determined_tpu_torch.train import TorchTrial


class BadTrial(TorchTrial):
    def init_params(self, rng):
        return {
            # 32768 x 256 fp32 = 32 MiB, no logical axes -> replicated.
            "embedding": torch.randn(32768, 256, generator=rng,
                                     device=rng.device) * 0.02,
            "head": torch.randn(256, 8, generator=rng,
                                device=rng.device) * 0.02,
        }

    def loss(self, params, batch, rng):
        x = params["embedding"][batch["tokens"].long()]
        logits = x.mean(dim=1) @ params["head"]
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, batch["labels"].long()[:, None])[:, 0]
        loss = nll.mean()
        metrics = {"loss_scalar": loss.item()}  # DTL101
        return loss, metrics

    def build_training_data(self):
        rng = np.random.default_rng(0)
        while True:
            yield {
                "tokens": rng.integers(0, 32768, (64, 16)),
                "labels": rng.integers(0, 8, (64,)).astype(np.int32),
            }
